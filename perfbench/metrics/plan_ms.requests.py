"""The planner per ``search_many`` request: the engine's ``batch.plan``
spans (search._build_plans), in milliseconds a request."""


def read(run):
    return run.per_unit_ms({"batch.plan"}, "requests")
