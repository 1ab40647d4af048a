"""retried_pct: reads the retry ladder mapped again (engine.report()'s
retried_reads over the traced window's stream; a read retried at two tiers
counts twice) per 100 reads the stream was given."""


def read(run: dict):
    w = run["window"]
    return 100.0 * w["retried_reads"] / w["pulled_reads"] if w["pulled_reads"] else None
