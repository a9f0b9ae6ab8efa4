"""Training across processes (port of robot3dlotus_tpu/parallel): dist.py."""
