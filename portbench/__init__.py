"""The benchmark of platanus_b_tpu_torch on one NVIDIA H100.

`run.py` is the command; the rest is the yardstick: the read generator,
the plain reference and the comparison that decides `correct`, the
tracing that reads the per-layer metrics, and the data files that name
each configuration, mix and metric. Nothing here imports jax or the JAX
package, and the reference imports nothing of the port.
"""
