"""Dispatch per batch of a pipelined stream: the engine's
``pipeline.submit`` spans less the ``batch.plan`` spans inside them
(search._submit_plans: group, chunk, pack, upload, launch), in
milliseconds a batch."""


def read(run):
    submit = run.per_unit_ms({"pipeline.submit"}, "pipelined")
    plan = run.per_unit_ms({"batch.plan"}, "pipelined")
    if submit is None:
        return None
    return submit - (plan or 0.0)
