"""Worker processes for tests/test_torch_dist.py: one gloo rank each, on
the CPU. Imports torch and the port only (no JAX), so that a spawned rank
starts fast; the job and its inputs come as numpy arrays in a file, and
each rank writes its results to a file of its own."""

import os
import pickle


def run_rank(rank: int, world: int, workdir: str):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "job.pkl"), "rb") as fh:
        job = pickle.load(fh)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
                            rank=rank, world_size=world)
    try:
        out = _jobs(job, torch)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def _jobs(job, torch):
    import importlib

    from zkarray_torch.dist import fft_sharded, gather_shards, make_mesh, msm_sharded
    from zkarray_torch.ec.sw import AffinePoints
    from zkarray_torch.interop import limbs_from_numpy, limbs_to_numpy

    curves = importlib.import_module(f"zkarray_torch.curves.{job['curve']}")
    mesh = make_mesh(job["world"])
    out = {"rank": mesh.rank, "size": mesh.size}
    if "msm" in job:
        px, py, inf, sc, c = job["msm"]
        pts = AffinePoints(limbs_from_numpy(px, "cpu"), limbs_from_numpy(py, "cpu"),
                           torch.from_numpy(inf))
        res = msm_sharded(curves.G1, pts, limbs_from_numpy(sc, "cpu"), mesh, c=c)
        out["msm"] = [limbs_to_numpy(v) for v in res]
    if "fft" in job:
        x, w, n1 = job["fft"]
        xt = limbs_from_numpy(x, "cpu")
        whole = fft_sharded(curves.FR, xt, mesh, w, n1=n1)
        m = x.shape[1] // mesh.size
        mine = xt[:, mesh.rank * m:(mesh.rank + 1) * m].contiguous()
        local = fft_sharded(curves.FR, mine, mesh, w, n1=n1, local=True)
        out["fft_shard"] = limbs_to_numpy(whole)
        out["fft_local_equal"] = bool(torch.equal(whole, local))
        out["fft_gathered"] = limbs_to_numpy(gather_shards(whole, mesh))
    return out
