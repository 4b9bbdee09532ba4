"""Multi-device layer (twin of ``gaussian_process_optimization_tpu/parallel``):
``sharded`` holds the mesh and the sharded and distributed programs."""
