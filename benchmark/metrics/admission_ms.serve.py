"""Mean wall ms of the engine's admission rounds (``_admit_all``) inside
the traced window that admitted at least one request: the benchmark's
span around the hook; a round ends in a host sync (the first tokens'
copy to the host)."""

from benchmark.lib.serve import admission_rounds


def read(run):
    rounds = admission_rounds(run)
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
