"""Dynamic-batching core shared by the serving stages."""
