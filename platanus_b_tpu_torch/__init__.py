"""platanus_b_tpu_torch — platanus_b_tpu on PyTorch + CUDA.

A second package beside ``platanus_b_tpu`` (the JAX reference). Module and
function names follow the JAX package so each counterpart is easy to find:

- ``ops.keys``      <- ``ops/multiword.py`` (k-mer keys as int64 lanes)
- ``ops.kmer``      <- ``ops/kmer.py`` (+ the ``kmer_extract`` CUDA kernel)
- ``ops.count``     <- ``ops/count.py`` (sort + run-length counting)
- ``ops.search``    <- ``ops/search.py``
- ``ops.gapcost``   the long-read chaining DP's gap cost as XLA's CPU
  backend computes it (``models/longread.py:_chain_kernel``)
- ``ops.align``     <- ``ops/align.py`` + ``ops/pallas_align.py`` (+ the
  ``edit_distance`` CUDA kernel, the port of the Pallas ``_bed_kernel``)
- ``models.*``      <- ``models/*`` (+ the ``ungap_align`` CUDA kernel in
  ``models.mapper``)
- ``commands.*``    <- ``commands/*``
- ``parallel.multihost`` <- ``parallel/multihost.py`` (torchrun bring-up,
  ingest plan, host gathers and the key-range sharded merge; CPU tensors
  over gloo)
- ``parallel.sharding``  <- ``parallel/sharding.py`` (key-space-sharded
  count, adjacency and mapping over a process group; NCCL on the card)

The package is self-contained: it imports nothing of the JAX package.
The host-only modules it needs (``io``, ``utils.errors``,
``utils.constants``, ``native``) are copies of the JAX package's, pinned
to the reference's text by tests/test_torch_scaffold.py; the native IO
library builds into ``build/`` here. Every device function takes its
tensors (or an explicit ``device``); there is no global default device.
Run as ``python -m platanus_b_tpu_torch``.
"""

__version__ = "0.1.0"
REFERENCE_VERSION = "1.3.2"  # platanus_b version we reproduce (common.cpp:26)

__all__ = ["REFERENCE_VERSION", "__version__"]
