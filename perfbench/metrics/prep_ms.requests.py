"""Host prep per ``search_many`` request: the engine's ``prep.*`` spans
(search._prepare_many: parse, filters, term lookup, fuzzy), in
milliseconds a request."""

PREP = {"prep.parse", "prep.prime", "prep.resolve", "prep.fuzzy",
        "prep.prepare"}


def read(run):
    return run.per_unit_ms(PREP, "requests")
