"""kpop-tpu: a JAX/XLA framework for assembly-free,
alignment-free comparative analysis of genomes via full k-mer spectra.

Re-designed from scratch with the capabilities of PaoloRibeca/KPop
(reference layout: bin/KPopCount.ml, bin/KPopCountDB.ml, bin/KPopTwistDB.ml,
src/KPopTwist, lib/{KMerDB,Matrix,Space,Twister}.ml), but built for accelerators:

- dense sharded ``[n_kmers, n_samples]`` spectra instead of hash tables,
- correspondence analysis as a distributed JAX Gram-matrix eigendecomposition
  instead of R's ``ca`` package,
- batched matmuls for twist projection and all-pairs distances instead of
  fork-parallel scalar loops,
- ``jax.sharding.Mesh`` + ``shard_map`` collectives instead of fork+pipes.

File-format interoperability with the reference's *text* formats
(``.KPopSpectra.txt``, ``.KPopCounter.txt``, ``.KPopTwisted.txt``,
``.KPopTwister.txt``, ``.KPopInertia.txt``, ``.KPopDMatrix.txt``,
``.KPopSummary.txt``) is preserved, as are the register/action CLI semantics.
"""

__version__ = "0.1.0"

from . import config as config
