"""Data-parallel training over ranks (torch.distributed)."""
