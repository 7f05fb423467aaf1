"""The training step: loss -> grads -> Tri-Accel control -> update.

Two of the reference's three update paths are ported; all control math
stays on the device and neither step makes a host sync:

  reference (``fused_update=False``, ``reference_step``) — the tree-form,
  unfused oracle: the f32 master params are cast to the compute dtype
  inside the loss (with the in-loss QDQ when dynamic precision is on),
  the gradient of every leaf comes back as a tree, then the finite check,
  global-norm clip, per-layer moments, ``opt.update`` and
  ``apply_updates`` run leaf by leaf, and a non-finite step keeps the old
  params, moments and aux state through ``torch.where``. It runs the
  paper's FP32 baseline and the static-AMP baseline (``--no-triaccel``).

  slab-resident fused (``resident_step``) — the f32 master, the optimizer
  moments and the next-step compute copy live as single (rows, 512) slabs
  across steps. The forward unpacks views of the compute slab (a leaf with
  ``requires_grad``), so ``torch.autograd.grad`` returns the gradient
  already in slab layout; the two fused kernels then read it — phase 1 for
  the per-layer statistics, phase 2 for the optimizer step, master write
  and the next compute copy.

The tree-form fused step (fused but not resident: a params tree with
non-floating leaves) is not ported; no ported model has such a tree.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree as tu
from repro_torch.core.controller import ControlState, lr_scales, update_control
from repro_torch.core.precision import TriAccelConfig, make_qdq_fn
from repro_torch.kernels import ops
from repro_torch.kernels.fused_update import cast_scales, seed_compute
from repro_torch.kernels.layout import SlabView, slab_view
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          global_norm)


class TrainState(NamedTuple):
    params: Any          # f32 master: ONE (rows, 512) slab when resident
    aux_state: Any       # non-differentiated model state (BN stats)
    opt_state: Any
    control: ControlState
    #: fused-update carry: {"slab": next-step compute copy, "p_amax": (L,)}
    #: on the resident path ({"tree": ...} before ``pack_state``); () on
    #: the reference path
    compute: Any = ()


def cast_params(params, dtype):
    return tu.tree_map(
        lambda p: p.to(dtype) if p.dtype.is_floating_point else p, params)


def _tree_finite(tree) -> torch.Tensor:
    """One 0-d bool on the device: every element of every leaf finite."""
    leaves = tu.leaves(tree)
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()


def resolve_fused(opt: Optimizer, tac: TriAccelConfig) -> bool:
    """The fused update needs an optimizer kernel spec and dynamic
    precision (the static baselines need reference_step)."""
    return opt.spec is not None and tac.dynamic_precision


def _cast_codes(task, grouping, codes: torch.Tensor) -> torch.Tensor:
    """Codes the next-step cast actuates: layers beyond the slice the loss
    consumes (``task.loss_codes``) cast at code 2 (container only)."""
    L = grouping.num_layers
    n_act = task.loss_codes(torch.zeros((L,), dtype=torch.int32)).shape[0]
    if n_act >= L:
        return codes
    keep = torch.arange(L, device=codes.device) < n_act
    return torch.where(keep, codes, 2).to(torch.int32)


def init_compute(task, params, grouping, control: ControlState,
                 tac: TriAccelConfig):
    """Seed ``TrainState.compute``: the compute copy the first step's
    forward consumes + the per-layer param absmax table."""
    view = slab_view(params, grouping)
    return seed_compute(view, params,
                        _cast_codes(task, grouping, control.codes),
                        tac.ladder, task.compute_dtype)


_OPT_SLAB_KEYS = ("mu", "m", "v")


def pack_state(view: SlabView, state: TrainState,
               cp_dtype=None) -> TrainState:
    """Tree-form ``TrainState`` -> slab-resident form (once, at init)."""
    p_slab = view.pack(state.params, torch.float32)
    opt2 = {k: (view.pack(v, torch.float32) if k in _OPT_SLAB_KEYS else v)
            for k, v in state.opt_state.items()}
    compute = state.compute
    if isinstance(compute, dict) and "tree" in compute:
        cd = cp_dtype if cp_dtype is not None else \
            tu.leaves(compute["tree"])[0].dtype
        compute = {"slab": view.pack(compute["tree"], cd),
                   "p_amax": compute["p_amax"]}
    return state._replace(params=p_slab, opt_state=opt2, compute=compute)


def unpack_state(view: SlabView, state: TrainState,
                 params_like) -> TrainState:
    """Slab-resident ``TrainState`` -> tree form (views of the slabs)."""
    params = view.unpack(state.params, like=params_like)
    opt2 = {k: (view.unpack(v, like=params_like) if k in _OPT_SLAB_KEYS
                else v) for k, v in state.opt_state.items()}
    compute = state.compute
    if isinstance(compute, dict) and "slab" in compute:
        compute = {"tree": view.unpack(compute["slab"], like=params_like),
                   "p_amax": compute["p_amax"]}
    return state._replace(params=params, opt_state=opt2, compute=compute)


def split_microbatches(batch, accum: int):
    """(accum, B/accum, ...) microbatch stacks; raises when the batch does
    not divide evenly into ``accum`` microbatches."""
    out = {}
    for k, x in batch.items():
        if x.dim() < 1:
            out[k] = x.expand((accum,) + tuple(x.shape))
            continue
        if x.shape[0] % accum:
            raise ValueError(
                f"batch leaf {k!r} has leading dim {x.shape[0]}, not "
                f"divisible by accum={accum}; pick a global batch that is a "
                "multiple of accum")
        out[k] = x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))
    return out


def _grads(loss_fn, wrt, aux_state, batch, accum: int):
    """Gradients w.r.t. the tensors ``wrt`` of ``loss_fn(aux_state,
    microbatch) -> (total, new_aux, metrics)`` over one batch or a loop of
    ``accum`` microbatches (then their f32 SUM, the floating metrics
    averaged) -> (grads, new_aux, metrics)."""
    if accum == 1:
        total, new_aux, metrics = loss_fn(aux_state, batch)
        return list(torch.autograd.grad(total, wrt)), new_aux, metrics
    mbs = split_microbatches(batch, accum)
    g_acc = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
             for w in wrt]
    aux, mlist = aux_state, []
    for i in range(accum):
        total, aux, m = loss_fn(aux, {k: v[i] for k, v in mbs.items()})
        g_acc = [a + g for a, g in zip(g_acc,
                                       torch.autograd.grad(total, wrt))]
        mlist.append(m)
    metrics = {k: (torch.stack([m[k].float() for m in mlist]).mean(0)
                   if mlist[0][k].is_floating_point() else mlist[-1][k])
               for k in mlist[0]}
    return g_acc, aux, metrics


def _control_metrics(metrics, finite, control2, lr):
    metrics = dict(metrics)
    codes = control2.codes
    metrics.update({
        "grads_finite": finite,
        "loss_scale": control2.loss_scale,
        "lr": lr,
        "mean_code": codes.float().mean(),
        "frac_low": (codes == 0).float().mean(),
        "frac_fp32": (codes == 2).float().mean(),
    })
    return metrics


def _layer_counts(grouping):
    """``grouping.counts`` on a device, copied there once."""
    counts = {}

    def on(dev):
        if dev not in counts:
            counts[dev] = grouping.counts.to(dev)
        return counts[dev]
    return on


def make_train_step(task, tac: TriAccelConfig, opt: Optimizer, grouping,
                    schedule: Callable, accum: int = 1,
                    grad_clip: float = 0.0, fused_update=None,
                    resident_params=None):
    """Returns ``step(state, batch) -> (state, metrics)``: ``reference_step``
    over tree-form state when ``fused_update`` is False (None resolves by
    ``resolve_fused``), else ``resident_step`` over slab-resident state,
    whose layout ``resident_params`` (a params-shaped tree; meta tensors
    do) fixes."""
    if fused_update is None:
        fused_update = resolve_fused(opt, tac)
    if fused_update and opt.spec is None:
        raise ValueError("fused_update=True needs an optimizer with a "
                         "kernel spec (repro_torch.optim.optimizers.sgdm/"
                         "adamw)")
    if not fused_update:
        return _make_reference_step(task, tac, opt, grouping, schedule,
                                    accum, grad_clip)
    if resident_params is None:
        raise NotImplementedError(
            "the tree-form fused_step is not ported; pass resident_params "
            "for the slab-resident step (ROADMAP A6)")
    if not all(l.dtype.is_floating_point for l in tu.leaves(resident_params)):
        raise ValueError("slab residency needs an all-floating params tree")
    r_view = slab_view(resident_params, grouping)
    r_like = resident_params
    spec = opt.spec
    L = grouping.num_layers
    counts = _layer_counts(grouping)

    def loss_resident(cp_slab, loss_scale):
        def loss_fn(aux_state, microbatch):
            cp = r_view.unpack(cp_slab, like=r_like)
            total, new_aux, metrics = task.loss(cp, aux_state, microbatch,
                                                None, None)
            return total * loss_scale, new_aux, metrics
        return loss_fn

    def resident_step(state: TrainState, batch):
        p_slab, aux_state, opt_state, control, compute = state
        dev = p_slab.device
        ls = control.loss_scale
        wrt = compute["slab"].detach().requires_grad_(True)
        (g_slab,), new_aux, metrics = _grads(loss_resident(wrt, ls), [wrt],
                                             aux_state, batch, accum)
        row_layer = r_view.row_blocks(dev)

        # phase 1: one gradient read -> per-layer stats
        sums, sumsqs, gmax, nonfinite = ops.fused_stats(g_slab, row_layer, L)

        denom = ls * accum
        s_l = sums / denom
        ss_l = sumsqs / (denom * denom)
        finite = nonfinite.sum() == 0
        if grad_clip > 0:
            gn = torch.sqrt(ss_l.sum())
            clip = torch.clamp_max(torch.full_like(gn, grad_clip)
                                   / torch.clamp_min(gn, 1e-9), 1.0)
        else:
            clip = torch.ones((), dtype=torch.float32, device=dev)
        moments = (s_l * clip, ss_l * (clip * clip), counts(dev))
        control2 = update_control(control, moments, tac, finite)
        lr = schedule(control2.step) * control2.lr_demote
        lr_l = (lr_scales(control2, tac) * lr).to(torch.float32)

        if spec.kind == "adamw":
            t = opt_state["t"] + 1
            tf = t.to(torch.float32)
            c1 = 1.0 - spec.b1 ** tf
            c2 = 1.0 - spec.b2 ** tf
            m_slab, v_slab = opt_state["m"], opt_state["v"]
        else:
            c1 = c2 = torch.ones((), dtype=torch.float32, device=dev)
            m_slab, v_slab = opt_state["mu"], None
        scalars = torch.stack([clip / denom, finite.to(torch.float32), c1,
                               c2, control2.step.to(torch.float32)]
                              ).to(torch.float32)

        # phase 2: the resident slabs flow straight through the kernel
        p_new, m_new, v_new, cp_slab, p_amax = ops.fused_apply(
            g_slab, p_slab, m_slab, v_slab, scalars, row_layer,
            r_view.gather_rows(lr_l),
            r_view.gather_rows(_cast_codes(task, grouping, control2.codes)),
            r_view.gather_rows(cast_scales(compute["p_amax"])),
            spec=spec, ladder=tac.ladder, cp_dtype=task.compute_dtype,
            num_layers=L, sr=tac.stochastic_round)

        if spec.kind == "adamw":
            opt_state2 = {"m": m_new, "v": v_new,
                          "t": torch.where(finite, t, opt_state["t"])}
        else:
            opt_state2 = {"mu": m_new}
        # a skipped (non-finite) step keeps the old BN state too
        new_aux = tu.tree_map(lambda a, b: torch.where(finite, a, b),
                              new_aux, aux_state)
        compute2 = {"slab": cp_slab, "p_amax": p_amax}

        metrics = _control_metrics(metrics, finite, control2, lr)
        metrics["grad_absmax"] = gmax.max() / denom
        return TrainState(p_new, new_aux, opt_state2, control2,
                          compute2), metrics

    return resident_step


def reference_grads(task, qdq_fn, params32, aux_state, batch, codes, ls,
                    accum: int = 1):
    """The reference path's gradient: the f32 master tree cast to the
    compute dtype inside the loss (``codes`` through ``qdq_fn`` when that
    is given), the loss scaled by ``ls``; the gradient of every leaf,
    summed over ``accum`` microbatches, then divided by ``accum`` and by
    ``ls`` in f32 -> (grads tree, new_aux, metrics)."""
    leaves, treedef = tu.flatten(params32)
    wrt = [p.detach().requires_grad_(True) for p in leaves]

    def loss_at(aux, microbatch):
        cp = cast_params(tu.unflatten(treedef, wrt), task.compute_dtype)
        total, new_aux, metrics = task.loss(cp, aux, microbatch, codes,
                                            qdq_fn)
        return total * ls, new_aux, metrics

    g, new_aux, metrics = _grads(loss_at, wrt, aux_state, batch, accum)
    grads = tu.unflatten(treedef, g)
    if accum > 1:
        grads = tu.tree_map(lambda x: x / accum, grads)
    return tu.tree_map(lambda x: x.float() / ls, grads), new_aux, metrics


def _make_reference_step(task, tac: TriAccelConfig, opt: Optimizer,
                         grouping, schedule: Callable, accum: int,
                         grad_clip: float):
    """``reference_step`` over tree-form state (the reference's
    ``train_step.py`` reference path), leaf by leaf."""
    qdq_fn = make_qdq_fn(tac)
    counts = _layer_counts(grouping)

    def reference_step(state: TrainState, batch):
        params32, aux_state, opt_state, control = state[:4]
        grads, new_aux, metrics = reference_grads(
            task, qdq_fn, params32, aux_state, batch,
            task.loss_codes(control.codes), control.loss_scale, accum)
        finite = _tree_finite(grads)
        if grad_clip > 0:
            gn = global_norm(grads)
            # a true division: ``grad_clip / gn`` would be a reciprocal
            # and a multiply
            clip = torch.clamp_max(torch.full_like(gn, grad_clip)
                                   / torch.clamp_min(gn, 1e-9), 1.0)
            grads = tu.tree_map(lambda x: x * clip, grads)

        # Tri-Accel §3.4 device-side control update
        s_l, ss_l, _ = grouping.moments(grads)
        control2 = update_control(control, (s_l, ss_l, counts(s_l.device)),
                                  tac, finite)
        scales = lr_scales(control2, tac)                       # (L,)
        lr = schedule(control2.step) * control2.lr_demote
        lr_tree = grouping.broadcast(scales * lr, params32)

        updates, opt_state2 = opt.update(grads, opt_state, params32, lr_tree)
        new_params = apply_updates(params32, updates)
        # skip the step entirely on non-finite grads (fp16 ladder semantics)
        keep = lambda new, old: tu.tree_map(                    # noqa: E731
            lambda a, b: torch.where(finite, a, b), new, old)
        new_params = keep(new_params, params32)
        opt_state2 = keep(opt_state2, opt_state)
        new_aux = keep(new_aux, aux_state)

        metrics = _control_metrics(metrics, finite, control2, lr)
        return TrainState(new_params, new_aux, opt_state2, control2,
                          state.compute), metrics

    return reference_step
