"""The comparison that decides ``correct``: what the timed path produced,
against the plain fp32 reference on the same inputs and weights.

Numbers compared (each held to its cell's limit in ``limits/``):

  logits_err  prefill: ||program - reference|| / ||reference|| of the
              last-position logits, the worst sampled request
  logits_err_best  the same, the best sampled request
  cache_err   prefill: the same of every cache tensor of every layer (K and
              V, or MLA's c_kv and k_rope), the worst layer of the worst
              request
  token_gap   served: the widest gap, in standard deviations of the
              reference's logits at that position, by which the logit of a
              token the served path generated lies below the reference's
              best
  gap_p99     served: the 99th percentile of those gaps
  mismatch_share  served: the share of generated tokens that are not the
              reference's best at their position

The control (``quant="fp8"``) is the reference itself in the program's
place, every product's operands rounded to float8: its readings set the
upper end of each limit (PERF.md).
"""

from __future__ import annotations

import torch

from portbench.reference.plain import fp32_mode


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def gap(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """(best - logit of ``chosen``) / std over the last dimension, per row."""
    ref_logits = ref_logits.double()
    picked = ref_logits.gather(-1, chosen.long()[..., None])[..., 0]
    return (ref_logits.amax(-1) - picked) / ref_logits.std(-1)


def prefill_numbers(family, w, cfg, tokens, rows, logits, cache_layers, *,
                    quant_as_program=None) -> list:
    """The numbers of the prefill requests ``rows`` of one call (tokens
    (B, S), the rows that the reference must see together): each row's
    program logits (V',) in ``logits`` and per-layer cache tensors [(t, ...),
    ...] in ``cache_layers``, against the reference. With
    ``quant_as_program`` the program's outputs are replaced by the
    reference computed that way (the control)."""
    v = cfg["vocab_size"]
    out = []
    with fp32_mode():
        h, ref_cache = family.forward(w, cfg, tokens)
        if quant_as_program is not None:
            hq, q_cache = family.forward(w, cfg, tokens, quant=quant_as_program)
            logits = [family.head(w, cfg, hq[r, -1], quant=quant_as_program) for r in rows]
            cache_layers = [[tuple(t[r] for t in layer) for layer in q_cache] for r in rows]
        for r, got, layers in zip(rows, logits, cache_layers):
            ref = family.head(w, cfg, h[r, -1])
            got = got[:v].float()
            cache_err = max(rel_err(g, want[r]) for gl, rl in zip(layers, ref_cache)
                            for g, want in zip(gl, rl))
            out.append(dict(logits_err=rel_err(got, ref), cache_err=cache_err))
    return out


def served_numbers(family, w, cfg, prompts, outputs, *, quant_as_program=None,
                   block: int = 2048):
    """The numbers of one served group: prompts (B, P) and the generated
    tokens (B, N), all of the group's requests at once, since a decode step
    routes the batch's tokens together. With ``quant_as_program`` they are
    read for the tokens the reference computed that way puts first."""
    p = prompts.shape[1]
    seq = torch.cat([prompts, outputs], dim=1)[:, :-1]             # what decode_step was fed
    with fp32_mode():
        h, _ = family.forward(w, cfg, seq, groups="position", keep_cache=False)
        h = h[:, p - 1:].reshape(-1, h.shape[-1])                   # positions that generate
        chosen = outputs.reshape(-1)
        if quant_as_program is not None:
            hq, _ = family.forward(w, cfg, seq, quant=quant_as_program, groups="position",
                                   keep_cache=False)
            hq = hq[:, p - 1:].reshape(-1, hq.shape[-1])
            chosen = torch.cat([family.head(w, cfg, hq[i:i + block], quant=quant_as_program)
                                .argmax(-1) for i in range(0, hq.shape[0], block)])
        gaps = torch.cat([gap(family.head(w, cfg, h[i:i + block]), chosen[i:i + block].to(h.device))
                          for i in range(0, h.shape[0], block)])
        return dict(token_gap=float(gaps.max()), mismatch_share=float((gaps > 0).double().mean()),
                    gap_p99=float(torch.quantile(gaps.float(), 0.99)))


def summarise(readings: list) -> dict:
    """Each number's worst (largest) reading over the sampled requests or
    groups, and the best (smallest) logits_err as ``logits_err_best``."""
    out = {k: max(r[k] for r in readings) for k in readings[0]}
    if "logits_err" in out:
        out["logits_err_best"] = min(r["logits_err"] for r in readings)
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}): every number at or under its
    limit, none missing or NaN, and at least one limit."""
    shown = {k: {"value": numbers.get(k), "limit": limits.get(k)}
             for k in sorted(set(numbers) | set(limits))}
    ok = bool(limits) and all(isinstance(numbers.get(k), float) and numbers[k] <= lim
                              for k, lim in limits.items())
    return ok, shown
