"""Whether what the timed path served is right: the served tokens against
the plain float32 reference.

Once the window has closed and the program is freed, a sample of the
window's finished requests, drawn from the seed with the longest in it,
is run through the plain reference of the cell's architecture
(``architectures/<model_type>.py``'s ``forward``) over each prompt and
its served tokens, with the weights drawn again from the seed. At every
served position the gap is the reference's best logit less the logit of
the token the pod served. Three numbers come of it: the widest gap, the mean gap, and the
share of the served positions whose gap passes ``WIDE_GAP``; a cell's
file names the ones it holds to a limit.
The control (``control_gap``) reads the same numbers for the token the
reference computed in float8 puts first.
"""

from __future__ import annotations

from types import ModuleType

import numpy as np
import torch

from .model import Dims
from .weights import draw_block

#: the most requests a sample takes
SAMPLE_REQUESTS = 32

#: a served token this far below the reference's best logit counts toward
#: ``wide_gap_pct``: above the bfloat16 program's round-off, below what
#: float8 products move a logit by (PERF.md gives the readings)
WIDE_GAP = 0.2

NUMBERS = ("logit_gap", "mean_logit_gap", "wide_gap_pct")


def pick(requests: list, seed: int, tokens: int) -> list:
    """The finished requests to compare: the longest (prompt and answer)
    and others drawn from the seed until ``tokens`` served tokens."""
    done = [r for r in requests if r.seq is not None and r.error is None]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + r.answer_len, r.due))
    rest = [r for r in done if r is not longest]
    picked, n = [longest], longest.answer_len
    for i in np.random.default_rng([seed, 5]).permutation(len(rest)):
        if n >= tokens or len(picked) >= SAMPLE_REQUESTS:
            break
        picked.append(rest[i])
        n += rest[i].answer_len
    return picked


def _inputs(picked: list) -> tuple[list[list[int]], list[list[int]], list[torch.Tensor]]:
    seqs, want, served = [], [], []
    for r in picked:
        gen = list(r.seq.generated_tokens)
        seqs.append(list(r.prompt) + gen)
        want.append(list(range(len(r.prompt) - 1, len(r.prompt) - 1 + len(gen))))
        served.append(torch.tensor(gen, dtype=torch.long))
    return seqs, want, served


def _blocks(arch: ModuleType, m: Dims, seed: int, device):
    return lambda b: draw_block(arch, m, seed, b, device)


def _gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The gap of each of ``tokens`` below the best logit of its row."""
    tokens = tokens.to(logits.device)
    return logits.max(dim=-1).values - logits.gather(1, tokens[:, None])[:, 0]


def numbers(gaps: list[torch.Tensor]) -> dict:
    g = torch.cat(gaps)
    return {"logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
            "wide_gap_pct": 100.0 * float((g > WIDE_GAP).float().mean())}


def gaps(arch: ModuleType, m: Dims, seed: int, picked: list, device, control: bool = False
         ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per request, the gaps of the served tokens below the reference's
    best, and with ``control`` the gaps, below the same best, of the tokens
    the reference computed in float8 puts first. One request at a time,
    so that the reference fits beside what the card still holds; the
    float8 pass runs first and keeps only its choices."""
    seqs, want, served = _inputs(picked)
    out, ctl = [], []
    for s, w, t in zip(seqs, want, served):
        top = None
        if control:
            logits = arch.forward(m, _blocks(arch, m, seed, device), [s], [w], device, precision="fp8")[0]
            top = logits.argmax(dim=-1)
            del logits
        ref = arch.forward(m, _blocks(arch, m, seed, device), [s], [w], device)[0]
        out.append(_gaps(ref, t))
        if control:
            ctl.append(_gaps(ref, top))
        del ref
    return out, ctl


def served_gap(arch: ModuleType, m: Dims, seed: int, picked: list, device) -> dict:
    """The numbers of the served tokens' gaps below the reference's best."""
    served, _ = gaps(arch, m, seed, picked, device)
    return dict(numbers(served), tokens=sum(len(g) for g in served), requests=len(picked))


def control_gap(arch: ModuleType, m: Dims, seed: int, picked: list, device) -> dict:
    """The same numbers for the tokens the float8 reference puts first."""
    return numbers(gaps(arch, m, seed, picked, device, control=True)[1])
