"""The port's own spans of the traced window, reduced to what the per-layer
metrics of its renderers read.

The port (`raymarch_tpu_torch.utils.profiling`) records a span only while
a profiler records, and the traced window is a run's one profiler session,
so its store holds that window's frames: each `rmt.frame` (one entry call)
with the spans inside it (`rmt.upload`, `rmt.launch.<wrapper>`,
`rmt.band`, `rmt.gather`, `rmt.cull`) and the launches and bytes uploaded
that it added. A port without the spans gives nothing to read.
"""

from __future__ import annotations

import statistics


class Frame:
    """One recorded frame: its span (`rec`, at `index` of `spans`) and the
    spans inside it (`kids`)."""

    def __init__(self, index: int, spans: list, kids: list):
        self.index, self.spans, self.kids = index, spans, kids
        self.rec = spans[index]

    @property
    def ms(self) -> float:
        return (self.rec.end_ns - self.rec.start_ns) * 1e-6

    def time_in(self, match) -> float:
        """ms in the spans whose name `match` accepts, a span nested in
        another such span counted once."""
        total = 0
        for s in self.kids:
            if match(s.name) and not (s.parent is not None and match(self.spans[s.parent].name)):
                total += s.end_ns - s.start_ns
        return total * 1e-6

    def self_ms(self) -> float:
        """The frame's own time: its length less what its direct children
        cover."""
        return self.ms - sum(s.end_ns - s.start_ns for s in self.kids if s.parent == self.index) * 1e-6


def frames(run):
    """The traced window's frames (`Frame`), or None where there is nothing
    to read: an untraced run, a fit, a port without spans, no frame."""
    if run.kind != "frames" or run.trace is None:
        return None
    try:
        from raymarch_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    spans = read()
    heads, kids = {}, {}
    for i, s in enumerate(spans):
        if not s.end_ns or s.frame is None:
            continue
        if s.name == "frame" and s.parent is None:
            heads[s.frame] = i
        else:
            kids.setdefault(s.frame, []).append(s)
    return [Frame(i, spans, kids.get(k, [])) for k, i in heads.items()] or None


def mean_over_frames(run, value):
    """The mean over the traced window's frames of `value(frame)`, or None."""
    fs = frames(run)
    if fs is None:
        return None
    return statistics.mean(value(f) for f in fs)
