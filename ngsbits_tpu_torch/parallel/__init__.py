"""The mesh layer: a process group of ranks (``torch.distributed``) and the
sharded QC reduction steps (``mesh.py``)."""
