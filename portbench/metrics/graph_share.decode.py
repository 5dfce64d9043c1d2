"""graph_share.decode (%): the share of the traced window's
``decode_step`` ranges (``Model.make_decode_step``) that hold a
``decode_graph`` range: steps the program replayed as one CUDA graph
(``models/decode_graph.py``) rather than launching kernel by kernel.
None without device activity, or where the capture holds no
``decode_graph`` range at all (a program without the graph)."""


def read(run):
    t = run.trace
    if t is None or not t.device or not t.annotations.get("decode_graph"):
        return None
    steps = [(a, b) for a, b in t.annotations.get("decode_step", [])
             if a >= t.start and b <= t.end]
    if not steps:
        return None
    graphs = t.annotations["decode_graph"]
    held = sum(1 for a, b in steps
               if any(a <= c and d <= b for c, d in graphs))
    return 100.0 * held / len(steps)
