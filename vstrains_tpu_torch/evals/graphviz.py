"""Assembly-graph visualization export.

Replaces the reference's graph-tool draw_graph_api
(/root/reference/utils/VStrains_Utilities.py:1003-1012) with a
dependency-free Graphviz DOT writer (render elsewhere with `dot -Tsvg`).
Node labels carry id/depth/length; edge labels carry flow.
"""

from __future__ import annotations

from vstrains_tpu_torch.core.graph import GraphView


def write_dot(view: GraphView, path: str,
              max_seq_label: int = 8) -> None:
    def esc(s: str) -> str:
        return s.replace('"', r'\"')

    with open(path, "w") as f:
        f.write("digraph assembly {\n  rankdir=LR;\n"
                "  node [shape=box, fontsize=10];\n")
        for vid, v in view.nodes.items():
            label = (f"{esc(vid)}\\ndp={v.dp:.1f} len={len(v.seq)}")
            f.write(f'  "{esc(vid)}" [label="{label}"];\n')
        for (u, w), e in view.edges.items():
            f.write(f'  "{esc(u)}" -> "{esc(w)}" '
                    f'[label="{e.flow:.1f}", fontsize=8];\n')
        f.write("}\n")
