"""Bucket layout of the per-edge ESC structural count vector.

The contract (reference `utils_edge_efficient.py:126-144`): for each edge's
union-of-two-ego-nets subgraph, a fixed-size count vector is accumulated as

  [ 0 .. 199]  one count at bucket d       per subgraph node with in-subgraph
               out-degree d (self-loops included when self_loop=True)
  [200 .. 299] one count at bucket z0      per subgraph node, z0 = hop
               distance to root u (h+1 if unreachable)
  [300 .. 399] one count at bucket z1      per subgraph node (distance to v)
  [400 .. 499] (only if use_rd) one count at bucket int(float32(rd)) per
               subgraph node, rd = resistance distance to u via pinv of the
               subgraph Laplacian
  [next 1300]  one count per directed non-self-loop subgraph edge (a, b) at
               bucket 216*z0[a] + 36*z1[a] + 6*z0[b] + z1[b]  (base-6
               packing of the 4-tuple; valid for h <= 4 since labels <= 5)

Total 1800 dims with rd, 1700 without (edge-type block starts at 400).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EncodingLayout:
    use_rd: bool = True
    deg_buckets: int = 200
    z_classes: int = 100
    rd_buckets: int = 100
    edge_type_buckets: int = 1300

    @property
    def deg_offset(self) -> int:
        return 0

    @property
    def z0_offset(self) -> int:
        return self.deg_buckets

    @property
    def z1_offset(self) -> int:
        return self.deg_buckets + self.z_classes

    @property
    def rd_offset(self) -> int:
        assert self.use_rd
        return self.deg_buckets + 2 * self.z_classes

    @property
    def edge_type_offset(self) -> int:
        base = self.deg_buckets + 2 * self.z_classes
        return base + (self.rd_buckets if self.use_rd else 0)

    @property
    def dim(self) -> int:
        return self.edge_type_offset + self.edge_type_buckets

    def pack_tuple_base(self) -> tuple[int, int, int, int]:
        """Base-6 packing weights of (z0[a], z1[a], z0[b], z1[b])."""
        return (216, 36, 6, 1)
