"""The comparison that decides ``correct``: each sampled answer of the
window against the plain reference, worked out again from the
benchmark's own inputs after the program's state is freed.  The cell's
entry module (``entries/<entry>.py``) gives the reference's answer to a
call, the answer's series in the same order, and the limit.

Numbers compared, each with its limit:
- ``rel_l2.<label>``: the largest, over the sampled answers of a call
  label and their series, of ||answer - reference||_2 / ||reference||_2
  over the entries both hold as numbers;
- ``nan_mismatch``: entries NaN on one side only, over all answers (0);
- ``unchecked``: labels with no answer to compare, and answers of another
  shape (0);
- ``failed_calls``: calls of the window that raised (0).
"""

from __future__ import annotations

import numpy as np
import torch


class Sampler:
    """A seeded reservoir of ``k`` answers per call label (Algorithm R),
    so that memory stays bounded however many calls the window makes."""

    def __init__(self, seed, k):
        self.rng = np.random.default_rng(int(seed) % (1 << 63))
        self.k, self.seen, self.kept = int(k), {}, {}

    def offer(self, label, answer):
        n = self.seen.get(label, 0)
        kept = self.kept.setdefault(label, [])
        if n < self.k:
            kept.append(answer)
        else:
            j = int(self.rng.integers(0, n + 1))
            if j < self.k:
                kept[j] = answer
        self.seen[label] = n + 1


def gaps(got, want):
    """(relative L2 gap, NaN mismatches) of an answer against the
    reference, both (T, B)."""
    got = torch.as_tensor(np.asarray(got) if not isinstance(got, torch.Tensor) else got)
    got = got.to(device=want.device, dtype=torch.float64)
    want = want.to(torch.float64)
    gn, wn = torch.isnan(got), torch.isnan(want)
    both = ~gn & ~wn
    diff = torch.linalg.vector_norm((got - want)[both])
    ref = torch.linalg.vector_norm(want[both])
    rel = float(diff / ref) if ref > 0 else float(diff)
    return rel, int((gn != wn).sum())


def judge(session, sampler, failed, device):
    """[(name, value, limit)] of the run's comparison."""
    entry = session.entry
    checks, mismatch, unchecked = [], 0, 0
    for label in session.meta:
        answers = sampler.kept.get(label, [])
        if not answers:
            unchecked += 1
            continue
        want = entry.reference(session, label, torch.float64, device)
        worst = 0.0
        for answer in answers:
            got_all = entry.answers(answer)
            if len(got_all) != len(want):
                unchecked += 1
                continue
            for got, ref in zip(got_all, want):
                if tuple(np.shape(got)) != tuple(ref.shape):
                    unchecked += 1
                    continue
                rel, nan = gaps(got, ref)
                worst, mismatch = max(worst, rel), mismatch + nan
        checks.append((f"rel_l2.{label}", worst, entry.limit(session, label)))
        del want
    checks += [("nan_mismatch", mismatch, 0), ("unchecked", unchecked, 0),
               ("failed_calls", failed, 0)]
    return checks


def control(session, device):
    """{label: relative L2 gap} of the reference computed in bfloat16 (the
    precision below the configuration's float32) against the float64
    reference: the reading that a limit has to stay under."""
    out = {}
    for label in session.meta:
        want = session.entry.reference(session, label, torch.float64, device)
        low = session.entry.reference(session, label, torch.bfloat16, device)
        out[label] = max(gaps(g, w)[0] for g, w in zip(low, want))
    return out
