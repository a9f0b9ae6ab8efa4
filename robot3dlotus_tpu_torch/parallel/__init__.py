"""Training and serving across processes (port of
robot3dlotus_tpu/parallel): dist.py (the process group), mesh.py (the dp
x tp mesh and the tensor-parallel rules), zero.py (ZeRO-1)."""
