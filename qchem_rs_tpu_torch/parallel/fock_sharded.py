"""Integral-direct Fock build over a mesh: shell-quartet data parallelism
(port of ``qchem_rs_tpu/parallel/fock_sharded.py``).

The Schwarz-screened tile lists of the streaming direct build
(``ops/fock_stream.py``) are shared over the ranks of a mesh: every rank
runs the direct pass's kernels on its tiles and digests them into local
J/K partials, and one ``all_reduce`` each sums the partials. The dense SCF algebra (eigh,
DIIS, X) stays replicated. This is the compute-scaling builder;
``ops/fock_pair.PairSpaceShardedFockBuilder`` and
``parallel/v2_sharded.ColumnShardedPairFockBuilder`` scale the memory.
"""

from __future__ import annotations

from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder
from qchem_rs_tpu_torch.utils.system import MolecularSystem


class ShardedFockBuilder(StreamingFockBuilder):
    """Integral-direct J/K with the tile lists shared over ``mesh``, on
    the mesh's device."""

    def __init__(self, system: MolecularSystem, mesh, threshold: float = 1e-12, *,
                 engine: TiledEriEngine | None = None):
        super().__init__(system, threshold, engine=engine, mesh=mesh)
