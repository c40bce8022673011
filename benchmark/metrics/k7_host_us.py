"""k7_host_us: host time of one call of K7's wrapper (``merged_update``) in the merged CG's loop: the
program's span ``cg.update`` over the traced stretch, the profiler's own cost in it."""


def program_record(r):
    """The program's spans and counters over the traced stretch (``utils/profiling.recorded()``: they
    record only while a profiler records); None without a stretch, or where the program has none."""
    if r.kind != "cg" or r.stretch is None:
        return None
    from deal_and_ceed_on_gpu_torch.utils import profiling

    recorded = getattr(profiling, "recorded", None)
    return recorded() if recorded is not None else None


def span_us(r, name):
    """Host microseconds a call of the program's span ``name`` over the traced stretch; None where it
    never ran."""
    rec = program_record(r)
    s = rec["spans"].get(name) if rec else None
    if not s or s["calls"] == 0:
        return None
    return s["total_ns"] / s["calls"] / 1e3


def read(r):
    return span_us(r, "cg.update")
