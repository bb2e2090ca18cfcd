"""Port of ``avenir_tpu/utils/timefmt.py``: Java SimpleDateFormat ->
strptime translation for the date/time
patterns reference configs carry (taskSched.json ``dateFormat``,
StateTransitionRate's ``input.time.format`` — e.g. ``yyyy-MM-dd
HH:mm:ss``).  Token order matters: multi-char tokens are replaced before
any shorter overlapping ones would be."""

from __future__ import annotations

_JAVA_TIME_TOKENS = [("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"),
                     ("HH", "%H"), ("mm", "%M"), ("ss", "%S")]


def java_time_format(fmt: str) -> str:
    """Translate the SimpleDateFormat subset used by the reference configs
    to a strptime pattern."""
    for java, py in _JAVA_TIME_TOKENS:
        fmt = fmt.replace(java, py)
    return fmt
