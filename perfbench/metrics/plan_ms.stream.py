"""The planner per batch of a pipelined stream: the engine's
``batch.plan`` spans (search._build_plans), in milliseconds a batch."""


def read(run):
    return run.per_unit_ms({"batch.plan"}, "pipelined")
