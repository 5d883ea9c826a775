"""Share of a pipelined stream's rows that the impact-prefix executor
served (search.EXEC_STATS over the window: ``prefix`` over the rows of
every executor)."""

EXECUTORS = ("prefix", "sliced", "blockdense", "candidate", "dense")


def read(run):
    if run.send != "pipelined":
        return None
    rows = sum(run.exec_stats.get(k, 0) for k in EXECUTORS)
    return run.exec_stats.get("prefix", 0) / rows if rows else None
