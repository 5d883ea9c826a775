"""Share of a pipelined stream's rows that the candidate and dense
executors served (search.EXEC_STATS over the window: ``candidate`` and
``dense`` over the rows of every executor, the executors that
prefix_rows.share.stream counts).  From 2**24 device slots the planner
routes every row there; a fast route past 2**24 lowers it."""

EXECUTORS = ("prefix", "sliced", "blockdense", "candidate", "dense")


def read(run):
    if run.send != "pipelined":
        return None
    rows = sum(run.exec_stats.get(k, 0) for k in EXECUTORS)
    plain = run.exec_stats.get("candidate", 0) + run.exec_stats.get(
        "dense", 0)
    return plain / rows if rows else None
