"""Closed-loop evaluation: the port's eval step (loss, greedy decode and
PER of a batch) on batches of a pooled set resident on the device, one
after the other, in an order drawn from the seed.

``correct`` judges every answer of the window: each batch's loss and PER
against the reference's for that batch, and the logits the port's head
gave for each distinct batch (taken by a forward hook at its first
appearance in the window) against the reference's. PER is held exactly,
but for its undecided windows: its edits may depart from the reference's
by at most two for each window whose argmax is not decided (a window
turned over splits or joins at most one run of symbols).
"""

from __future__ import annotations

import torch

from portbench.core import compare
from portbench.core.stats import rate
from portbench.core.trace import ModuleSpans, profiled
from portbench.core.weights import draw, sub_seed
from portbench.loops.train import mark, now, record, sync


def setup(run) -> None:
    cfg, tr, dev = run.cfg, run.traffic, run.device
    run.rows = int(tr["batch_rows"])
    nb = int(tr["pool_batches"])
    run.weights = draw(run.ref.leaves(cfg), run.seed, dev)
    mark(run, "weights")
    run.model = run.fam.build(cfg, run.weights, dev)
    run.model.eval()
    mark(run, "model")
    g_data = torch.Generator(device=dev).manual_seed(
        sub_seed(run.seed, "data"))
    pool = run.fam.make_pool(cfg, tr, nb * run.rows, g_data, dev)
    run.batches = [tuple(a[i * run.rows:(i + 1) * run.rows] for a in pool)
                   for i in range(nb)]
    g_order = torch.Generator().manual_seed(sub_seed(run.seed, "order"))
    run.order = torch.randperm(nb, generator=g_order).tolist()
    mark(run, "inputs")
    run.step = run.fam.eval_step(cfg, run.model)
    run.logits, run.current = {}, None

    def keep(_, __, out):
        if run.current is not None and run.current not in run.logits:
            run.logits[run.current] = out.detach().clone()

    run.hook = run.model.get_submodule(run.fam.LOGITS_MODULE) \
        .register_forward_hook(keep)
    run.fam.reset_launch_counts()
    run.step(run.batches[run.order[0]])  # warm-up, not judged
    run.note(launches_per_step=run.fam.launch_counts())
    run.results = []
    mark(run, "first_step")


def _batch(run) -> None:
    b = run.order[len(run.results) % len(run.order)]
    run.current = b
    out = run.step(run.batches[b])
    run.results.append((b, out["loss"], out["per"]))


def _batches(run, seconds: float, least: int = 1):
    sync(run.device)
    t0 = now()
    n = 0
    while n < least or now() - t0 < seconds:
        _batch(run)
        n += 1
    sync(run.device)
    return n, now() - t0


def window(run, seconds: float) -> dict:
    n, dt = _batches(run, seconds)
    run.attempted = n
    return {"eval_samples_per_s": rate(n * run.rows, dt)}


def traced(run, seconds: float):
    cfg, tr = run.cfg, run.traffic
    n_plain, dt_plain = _batches(run, seconds / 2)
    spans = ModuleSpans(run.model, cfg["rnn_modules"], backward=False)
    n_sp, _ = _batches(run, seconds / 4, least=2)
    spans = spans.close()
    with profiled(run.device) as prof:
        for _ in range(int(tr["profile_steps"])):
            with torch.profiler.record_function("step"):
                _batch(run)
    run.attempted = n_plain + n_sp + int(tr["profile_steps"])
    return record(run, "eval", n_plain, dt_plain, spans, prof,
                  run.fam.train_flops(cfg, tr, run.rows) / 3)


def release(run) -> None:
    run.hook.remove()
    run.answers = [(b, float(loss), float(per))
                   for b, loss, per in run.results]
    run.failed = sum(1 for _, loss, per in run.answers
                     if not (abs(loss) < float("inf")
                             and abs(per) < float("inf")))
    for name in ("model", "step", "results", "hook"):
        setattr(run, name, None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference(run, lower: bool) -> dict:
    seen = sorted({b for b, _, _ in run.answers})
    return {b: run.ref.eval_batch(run.cfg, run.weights, run.batches[b],
                                  lower=lower) for b in seen}


def _numbers(run, answers, logits) -> dict:
    ref = run.ref_out
    limit = run.limits["logits_gap"]
    slack = {b: 2 * int((~compare.decided(r["logits"], limit)
                         & r["valid"]).sum()) for b, r in ref.items()}

    def excess(b, per):
        if not abs(per) < float("inf"):
            return float("inf")
        edits = round(per * ref[b]["labels"] / 100)
        return max(0, abs(edits - ref[b]["edits"]) - slack[b])

    return {
        "logits_gap": max(compare.max_rel(logits[b], ref[b]["logits"])
                          for b in ref),
        "loss_gap": max(compare.rel_gap(loss, ref[b]["loss"])
                        for b, loss, _ in answers),
        "per_excess_edits": max(excess(b, per) for b, _, per in answers),
    }


def numbers(run) -> dict:
    run.ref_out = _reference(run, lower=False)
    missing = set(run.ref_out) - set(run.logits)
    if missing:
        raise RuntimeError(f"no logits kept for batches {sorted(missing)}")
    return _numbers(run, run.answers, run.logits)


def control_numbers(run) -> dict:
    ctl = _reference(run, lower=True)
    answers = [(b, ctl[b]["loss"], ctl[b]["per"]) for b, _, _ in run.answers]
    return _numbers(run, answers, {b: ctl[b]["logits"] for b in ctl})
