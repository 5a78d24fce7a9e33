"""chip_smoke.py's count of a kernel's launches in CUDA-graph replays:
the kernel's nodes in the captured graph's DOT dump times the replays.
The capture itself needs a card; the DOT reading and the wrapping of
`torch.cuda.CUDAGraph` are checked here.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

# a verbose `cuGraphDebugDotPrint` dump of a captured step: K3, an
# elementwise kernel, a memset and a reduction, labels cut short
DOT = r'''digraph dot {
subgraph cluster_5 {
label="graph_5" graph[style="dashed"];
"graph_5_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 3) | _ZN9zemb_rows16zemb_rows_kernelILi1ELb0ELb0EEEvPKfPKiS3_iiiiiPfS6_\<\<\<132,1024,8320\>\>\>}
| {{node handle | func handle} | {0x000000000AE5A5F0 | 0x000000000982C1C0}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_5_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 2) | _ZN2at6native29vectorized_elementwise_kernelILi4EEEviT0_T1_\<\<\<250,128,0\>\>\>}
| {cooperative | 0}
}"];

"graph_5_node_2"[style="solid" style="solid" shape="record" label="{MEMSET
| {{ID | node handle | dptr | pitch | value | elementSize | width | height} | {2 (topoId: 1) | 0x000000000AE5B4C0 | 0x00007FC1F0BF4400 | 0 | 0 | 1 | 4 | 1}}}"];

"graph_5_node_3"[style="bold" shape="record" label="{KERNEL
| {ID | 3 (topoId: 0) | _ZN2at6native13reduce_kernelILi512ELi1EEEvT1_\<\<\<\{1,32\},512,2048\>\>\>}
| {cooperative | 0}
}"];

"graph_5_node_0" -> "graph_5_node_1" [headlabel=0];
"graph_5_node_1" -> "graph_5_node_2" [headlabel=0];
"graph_5_node_2" -> "graph_5_node_3" [headlabel=0];
}
}
'''


@pytest.mark.parametrize("symbol,want", [
    ("", 4), ("{KERNEL", 3), ("{MEMSET", 1), ("zemb_rows_kernel", 1),
    ("segsum_kernel", 0), ("graph_5_node_1", 1)])
def test_dot_nodes_counts_declarations_not_edges(symbol, want):
    """A node counts once whatever its label holds; edge lines, which
    name two nodes each, count for none."""
    assert chip_smoke._dot_nodes(DOT, symbol) == want


def test_ledger_counts_nodes_times_replays():
    ledger = chip_smoke._GraphLedger()
    ledger.dots = [DOT, DOT.replace("zemb_rows_kernel", "other_kernel")]
    ledger.replays = [3, 5]
    assert ledger.nodes("zemb_rows_kernel") == 1
    assert ledger.launches("zemb_rows_kernel") == 3
    assert ledger.launches("{KERNEL") == 3 * 3 + 3 * 5
    ledger.clear_replays()
    assert ledger.replays == [0, 0] and ledger.launches("{KERNEL") == 0


def test_ledger_watch_puts_cuda_graph_back():
    """The wrapped capture end and replay are torch's own again after
    `watch()`, also when the watched code raises."""
    cls = torch.cuda.CUDAGraph
    before = (cls.capture_end, cls.replay)
    ledger = chip_smoke._GraphLedger()
    with pytest.raises(RuntimeError, match="inside"):
        with ledger.watch():
            assert (cls.capture_end, cls.replay) != before
            raise RuntimeError("inside")
    assert (cls.capture_end, cls.replay) == before
