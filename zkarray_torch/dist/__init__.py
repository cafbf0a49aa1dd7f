"""Multi-device MSM and NTT over torch.distributed (counterpart of
zkarray/dist/)."""

from zkarray_torch.dist.mesh import Mesh, make_mesh, make_mesh_2d
from zkarray_torch.dist.msm import msm_sharded
from zkarray_torch.dist.ntt import fft_fourstep, fft_sharded, gather_shards

__all__ = ["Mesh", "make_mesh", "make_mesh_2d", "msm_sharded", "fft_fourstep", "fft_sharded",
           "gather_shards"]
