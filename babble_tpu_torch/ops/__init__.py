"""Device kernels over the dense DAG state, in PyTorch.

The port's twin of the JAX package's ``ops`` (module for module):

- ``state``         — the struct-of-arrays DagState of tensors
- ``pack``          — 8:1 bit packing and popcount tallies
- ``ss``            — the strongly-see compare-count, and its blocked
                      partial ``ss_counts_acc``: a hand-written CUDA
                      kernel (``csrc/ss_count.cu``) beside its plain twin
- ``pallas_ingest`` — the last-ancestor walk: a hand-written CUDA kernel
                      (``csrc/la_walk.cu``) beside its plain twin
- ``ingest``        — coordinate fill, first descendants, rounds
- ``fame``          — virtual voting as a diagonal vote scan
- ``order``         — round received + median consensus timestamps
- ``wide``          — the column-blocked pipeline for wide participant axes
- ``stream``        — the rolling-window runner over ``wide``
"""
