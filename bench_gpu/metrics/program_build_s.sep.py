"""Seconds the program spent building its step programs in the run: every
key's first eager call and capture (``css_tpu_torch/utils/programs.py``,
``build_seconds()``: host time, freed programs included), all of it in
the set-up's warm sessions. Absent on the CPU, where programs run their
function directly and build nothing, and where the program keeps no such
total."""


def read(rec):
    from css_tpu_torch.utils import programs

    build_seconds = getattr(programs, "build_seconds", None)
    if build_seconds is None:
        rec.why.append("program_build_s: the program keeps no build seconds")
        return None
    seconds = build_seconds()
    if not seconds:
        rec.why.append("program_build_s: no program was built (programs "
                       "run directly off the card)")
        return None
    return seconds
