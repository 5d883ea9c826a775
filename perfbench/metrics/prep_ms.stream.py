"""Host prep per 2048-query batch of a pipelined stream: the engine's
``pipeline.prepare`` spans (search._prepare_many: parse, filters, term
lookup, fuzzy prefetch), in milliseconds a batch."""


def read(run):
    return run.per_unit_ms({"pipeline.prepare"}, "pipelined")
