"""Share of a request cell's impact-prefix dispatch groups that replayed
a captured CUDA graph: the engine's ``prefix.graph_replay`` over the
prefix groups it dispatched on the card (``prefix.graph_replay``,
``prefix.graph_capture`` and ``prefix.graph_eager``), over the window.
None where the engine has no such counters or dispatched no such
group."""

GROUPS = ("prefix.graph_replay", "prefix.graph_capture",
          "prefix.graph_eager")


def read(run):
    if run.send != "requests":
        return None
    groups = sum(run.exec_stats.get(k, 0) for k in GROUPS)
    replay = run.exec_stats.get("prefix.graph_replay", 0)
    return replay / groups if groups else None
