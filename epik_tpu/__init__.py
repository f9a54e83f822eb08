"""EPIK on an accelerator: a JAX phylogenetic-placement framework.

A from-scratch re-design of the capabilities of phylo42/EPIK (alignment-free
evolutionary placement with phylo-k-mers) for a GPU: the phylo-k-mer
database lives in device memory as flat gather targets, query reads stream
as padded batches through a jit-compiled lookup/score/top-k pipeline, and
multi-device scaling uses jax.sharding meshes (reads data-parallel,
database column- or hash-sharded with collective score merging).
"""

__version__ = "0.5.0"
