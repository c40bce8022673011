"""host_syncs: the program's blocking host reads of a device value (its counter ``host_syncs``: the
merged CG's residual reads and its control's check) over the traced stretch, per iteration of its solves."""

from benchmark.metrics.k7_host_us import program_record


def read(r):
    rec = program_record(r)
    iterations = sum(u.work for u in r.units if u.phase == "profiled")
    if not rec or "host_syncs" not in rec["counts"] or iterations == 0:
        return None
    return rec["counts"]["host_syncs"] / iterations
