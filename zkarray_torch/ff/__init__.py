"""Prime-field arithmetic."""
