"""Share of the candidate and dense executors' planes that holds
postings, in a pipelined stream: the engine's ``plain.lanes`` (the
posting lanes the dispatched rows hold) over ``plain.plane_lanes``
(the lanes of the planes as dispatched: padded rows x the postings
budget, or x the snapshot's slots for a dense group), over the window.
None where the engine has no such counters or dispatched no such
group."""


def read(run):
    if run.send != "pipelined":
        return None
    plane = run.exec_stats.get("plain.plane_lanes")
    if not plane:
        return None
    return run.exec_stats.get("plain.lanes", 0) / plane
