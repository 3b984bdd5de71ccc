"""Fused server update (reduce + rule + step): CUDA kernel and plain versions.

Port of ``repro/kernels/server_update.py``: ``server_update`` (Pallas
``_update_kernel``) and ``server_update_buffered`` (the same call with the
``(Kb, P)`` fedbuff ring appended as update rows, their weights gated by
``drain``).  Both wrappers launch the one kernel of
``csrc/server_update.cu`` on CUDA tensors and run their plain version on CPU
tensors; there is no fallback from one to the other.  The plain versions are
the reference's unfused compositions (``repro/kernels/ref.py``): the
weighted sum ``fedavg_reduce_plain`` followed by ``aggregators.apply_rule``.

Precision: the update rows and the ring come in fp32 or bf16 (one dtype for
both), ``params`` in the master dtype (fp32 or bf16), ``m`` and ``v`` in
fp32.  Every sum and the rule run in fp32; params' is written back in the
master dtype, m' and v' in fp32.

``server_update_grid`` and ``server_update_buffered_grid`` are the batched
grid round's forms (B3g and B4g, the reference kernels under the engine's
``vmap``): G lanes in one launch of the same kernel, the rule a ``(G,)``
int32 device tensor of global indices read by the kernel, never by the
host, and for B4g a ``(G, Kb, P)`` ring with a ``(G,)`` ``drain``.  Each
lane is bitwise the one-lane kernel on that lane.  Their plain versions run
the one-lane plain version lane by lane.  Every launch takes
``fedavg_reduce.column_plan``'s plan (``launch_plan``).
"""
from __future__ import annotations

import torch

from repro_torch.fl.aggregators import AGGREGATOR_ORDER, ServerHP, apply_rule
from repro_torch.kernels import count_launch, on_card, refuse_grad
from repro_torch.kernels.fedavg_reduce import (MAX_LANES, ROW_DTYPES, ColumnPlan,
                                               _vector_width, column_plan, fedavg_reduce_plain,
                                               sm_count)

# Kernel launches made by each wrapper (one per call on CUDA tensors).
launches = 0
buffered_launches = 0
grid_launches = 0
buffered_grid_launches = 0


# Rules that carry the server moments (fedavgm, fedadam, fedyogi); the
# kernel neither reads nor writes m and v under the others.
MOMENT_RULES = (1, 2, 3)


def _assert_registry_order():
    """The kernel's rule switch hardcodes the registry order: fail loudly
    if it is ever reordered without touching the kernel."""
    assert AGGREGATOR_ORDER == ("fedavg", "fedavgm", "fedadam", "fedyogi",
                                "stale", "fedbuff"), AGGREGATOR_ORDER


def _rule(delta, params, m, v, agg_idx, rnd, eta, beta1, beta2, tau):
    """The rule in fp32; params' back in the master dtype."""
    f32 = torch.float32
    hp = ServerHP(eta=eta, beta1=beta1, beta2=beta2, tau=tau)
    (m2, v2), p2 = apply_rule(agg_idx, (m.to(f32), v.to(f32)), params.to(f32), delta, rnd, hp)
    return p2.to(params.dtype), m2, v2


def server_update_plain(updates, weights, params, m, v, agg_idx, rnd, *,
                        eta=1.0, beta1=0.9, beta2=0.99, tau=1e-3):
    """``fedavg_reduce_plain`` followed by ``apply_rule`` -> (params', m', v')."""
    delta = fedavg_reduce_plain(updates, weights)
    return _rule(delta, params, m, v, agg_idx, rnd, eta, beta1, beta2, tau)


def server_update_buffered_plain(updates, weights, buf, buf_w, params, m, v, agg_idx,
                                 rnd, drain, *, eta=1.0, beta1=0.9, beta2=0.99, tau=1e-3):
    """The cohort's weighted sum (``server_update_plain``'s), plus the ring's
    weighted sum where ``drain`` holds, followed by ``apply_rule``.

    The two sums are separate products so that a lane that does not drain
    is ``server_update_plain`` bit for bit on any host: one product over
    the K + Kb rows would round the cohort's part by the BLAS path the host
    takes (MKL's AVX-512 ``sgemv`` rounds it unlike the K-row product).
    """
    drain = torch.as_tensor(drain, device=buf_w.device)
    delta = fedavg_reduce_plain(updates, weights)
    delta = torch.where(drain, delta + fedavg_reduce_plain(buf, buf_w), delta)
    return _rule(delta, params, m, v, agg_idx, rnd, eta, beta1, beta2, tau)


def _check_rows(name, x, device, dtypes, P=None):
    if x.device != device:
        raise ValueError(f"server_update: {name} is on {x.device}, expected {device}")
    if (x.dtype not in dtypes or x.dim() != 2 or not x.is_contiguous()
            or (P is not None and x.shape[1] != P)):
        raise ValueError(f"server_update: {name} must be a contiguous (rows, P) tensor of "
                         f"{dtypes}, got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] < 1:
        raise ValueError(f"server_update: {name} must have at least one row")


def _check_vec(name, x, n, device, dtypes=(torch.float32,)):
    if (x.device != device or x.dtype not in dtypes or x.shape != (n,)
            or not x.is_contiguous()):
        raise ValueError(f"server_update: {name} must be a contiguous ({n},) tensor of "
                         f"{dtypes} on {device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def launch_plan(device, lanes: int, P: int, updates: torch.Tensor, operands) -> ColumnPlan:
    """``column_plan`` of the kernel for ``lanes`` lanes of these rows; the
    load width aligns every operand the launch reads or writes."""
    vec = min(_vector_width(x, P) for x in operands)
    return column_plan(lanes, P, vec, updates.element_size(), sm_count(device))


def _launch(updates, weights, buf, buf_w, drain, params, m, v, agg_idx, rnd,
            eta, beta1, beta2, tau):
    from repro_torch.kernels.build import check, library

    refuse_grad("server_update", updates, weights, buf, buf_w, params, m, v)
    _assert_registry_order()
    device = updates.device
    _check_rows("updates", updates, device, ROW_DTYPES)
    K, P = updates.shape
    _check_vec("weights", weights, K, device)
    _check_vec("params", params, P, device, ROW_DTYPES)
    for name, x in (("m", m), ("v", v)):
        _check_vec(name, x, P, device)
    Kb = 0
    ring = ring_w = flag = None
    if buf is not None:
        # the ring's rows share the cohort rows' dtype (one row type a launch)
        _check_rows("buf", buf, device, (updates.dtype,), P=P)
        Kb = buf.shape[0]
        _check_vec("buf_w", buf_w, Kb, device)
        if drain.device != device or drain.dtype != torch.bool or drain.dim() != 0:
            raise ValueError(f"server_update: drain must be a 0-dim bool tensor on {device}")
        ring, ring_w, flag = buf.data_ptr(), buf_w.data_ptr(), drain.data_ptr()
    p_out = torch.empty_like(params)
    operands = [updates, params, p_out] + ([buf] if buf is not None else [])
    moments = int(agg_idx) in MOMENT_RULES
    if moments:
        m_out, v_out = torch.empty_like(m), torch.empty_like(v)
        operands += [m, v, m_out, v_out]
    else:  # the AXPY rules leave the moments as they are, as apply_rule does
        m_out, v_out = m, v
    mv = [x.data_ptr() if moments else None for x in (m, v, m_out, v_out)]
    plan = launch_plan(device, 1, P, updates, operands)
    with on_card(updates):
        stream = torch.cuda.current_stream(device).cuda_stream
        # (1 - beta) in double, rounded to float once, as the reference's Python floats
        status = library().server_update_launch(
            updates.data_ptr(), updates.element_size(), weights.data_ptr(), 1, K, ring, ring_w,
            Kb, flag, P, params.data_ptr(), params.element_size(), mv[0], mv[1], None,
            int(agg_idx), int(rnd), eta, beta1, 1.0 - beta1, beta2, 1.0 - beta2, tau, plan.vec,
            plan.runs, p_out.data_ptr(), mv[2], mv[3], stream,
        )
    check(status, "server_update")
    return p_out, m_out, v_out


def _device_of(updates: torch.Tensor) -> str:
    if updates.is_cuda:
        return "cuda"
    if updates.device.type != "cpu":
        raise ValueError(f"server_update: unsupported device {updates.device}")
    return "cpu"


def server_update(updates, weights, params, m, v, agg_idx, rnd, *,
                  eta=1.0, beta1=0.9, beta2=0.99, tau=1e-3):
    """Fused server update -> (params' in the master dtype, m', v' fp32), each (P,).

    ``agg_idx`` is the GLOBAL ``AGGREGATOR_ORDER`` index (a Python int);
    ``rnd`` is reserved for schedule-aware rules and ignored.
    """
    if _device_of(updates) == "cpu":
        return server_update_plain(updates, weights, params, m, v, agg_idx, rnd,
                                   eta=eta, beta1=beta1, beta2=beta2, tau=tau)
    out = _launch(updates, weights, None, None, None, params, m, v, agg_idx, rnd,
                  eta, beta1, beta2, tau)
    count_launch(__name__)
    return out


def server_update_buffered(updates, weights, buf, buf_w, params, m, v, agg_idx, rnd,
                           drain, *, eta=1.0, beta1=0.9, beta2=0.99, tau=1e-3):
    """Fused buffered server update (the fedbuff lane) -> (params', m', v').

    ``buf`` is the ``(Kb, P)`` ring, ``buf_w`` its drained-slot weights and
    ``drain`` a 0-dim bool tensor on the rows' device (never read back to
    the host).  With ``drain`` false the result equals ``server_update``.
    """
    if _device_of(updates) == "cpu":
        return server_update_buffered_plain(
            updates, weights, buf, buf_w, params, m, v, agg_idx, rnd, drain,
            eta=eta, beta1=beta1, beta2=beta2, tau=tau)
    out = _launch(updates, weights, buf, buf_w, drain, params, m, v, agg_idx, rnd,
                  eta, beta1, beta2, tau)
    count_launch(__name__, "buffered_launches")
    return out


# ---- B3g / B4g: G lanes a launch --------------------------------------------------------

ALL_RULES = tuple(range(len(AGGREGATOR_ORDER)))


def _lane_rules(rule_idx: torch.Tensor, registry) -> list:
    """The lanes' global rule indices, read on the CPU (the plain versions
    only), each checked against ``registry``."""
    rules = rule_idx.tolist()
    stray = sorted(set(rules) - set(registry))
    if stray:
        raise ValueError(f"server_update_grid: lane rules {stray} are not in the registry "
                         f"{tuple(registry)}")
    return rules


def _stack_lanes(outs, m, v, registry):
    """The lanes' (params', m', v') stacked; without a moment rule in the
    registry the moments are handed back as they are, as the kernel does."""
    p2 = torch.stack([o[0] for o in outs])
    if not any(r in MOMENT_RULES for r in registry):
        return p2, m, v
    return p2, torch.stack([o[1] for o in outs]), torch.stack([o[2] for o in outs])


def server_update_grid_plain(updates, weights, params, m, v, rule_idx, rnd, *,
                             registry=ALL_RULES, eta=1.0, beta1=0.9, beta2=0.99, tau=1e-3):
    """Lane g is ``server_update_plain`` of lane g under its rule
    ``rule_idx[g]`` -> (params', m', v'), each (G, P).

    The lanes go one call each: a batched product would round unlike the
    one-lane one (``fedavg_reduce_grid_plain``), and the rule is a Python
    int there.
    """
    hp = dict(eta=eta, beta1=beta1, beta2=beta2, tau=tau)
    rules = _lane_rules(rule_idx, registry)
    outs = [server_update_plain(updates[g], weights[g], params[g], m[g], v[g], rule, rnd, **hp)
            for g, rule in enumerate(rules)]
    return _stack_lanes(outs, m, v, registry)


def server_update_buffered_grid_plain(updates, weights, buf, buf_w, params, m, v, rule_idx,
                                      rnd, drain, *, registry=ALL_RULES, eta=1.0, beta1=0.9,
                                      beta2=0.99, tau=1e-3):
    """Lane g is ``server_update_buffered_plain`` of lane g under its rule
    and its ``drain[g]`` -> (params', m', v'), each (G, P)."""
    hp = dict(eta=eta, beta1=beta1, beta2=beta2, tau=tau)
    rules = _lane_rules(rule_idx, registry)
    outs = [server_update_buffered_plain(updates[g], weights[g], buf[g], buf_w[g], params[g],
                                         m[g], v[g], rule, rnd, drain[g], **hp)
            for g, rule in enumerate(rules)]
    return _stack_lanes(outs, m, v, registry)


def _check_lanes(name, x, shape, device, dtypes):
    if (x.device != device or x.dtype not in dtypes or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(f"server_update_grid: {name} must be a contiguous {shape} tensor of "
                         f"{dtypes} on {device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _launch_grid(updates, weights, buf, buf_w, drain, params, m, v, rule_idx, rnd, registry,
                 eta, beta1, beta2, tau):
    from repro_torch.kernels.build import check, library

    refuse_grad("server_update_grid", updates, weights, buf, buf_w, params, m, v)
    _assert_registry_order()
    device = updates.device
    if updates.dim() != 3:
        raise ValueError(f"server_update_grid: updates must be (G, K, P), got "
                         f"{tuple(updates.shape)}")
    G, K, P = updates.shape
    _check_lanes("updates", updates, (G, K, P), device, ROW_DTYPES)
    if K < 1 or not 1 <= G <= MAX_LANES:
        raise ValueError(f"server_update_grid: need K >= 1 and 1 <= G <= {MAX_LANES}, "
                         f"got G={G}, K={K}")
    _check_lanes("weights", weights, (G, K), device, (torch.float32,))
    _check_lanes("params", params, (G, P), device, ROW_DTYPES)
    _check_lanes("rule_idx", rule_idx, (G,), device, (torch.int32,))
    for name, x in (("m", m), ("v", v)):
        _check_lanes(name, x, (G, P), device, (torch.float32,))
    unknown = set(registry) - set(ALL_RULES)
    if unknown:
        raise ValueError(f"server_update_grid: registry holds unknown rules {sorted(unknown)}")
    Kb = 0
    ring = ring_w = flag = None
    if buf is not None:
        if buf.dim() != 3:
            raise ValueError(f"server_update_grid: buf must be (G, Kb, P), got {tuple(buf.shape)}")
        Kb = buf.shape[1]
        # the ring's rows share the cohort rows' dtype (one row type a launch)
        _check_lanes("buf", buf, (G, Kb, P), device, (updates.dtype,))
        _check_lanes("buf_w", buf_w, (G, Kb), device, (torch.float32,))
        _check_lanes("drain", drain, (G,), device, (torch.bool,))
        if Kb < 1:
            raise ValueError("server_update_grid: the ring must have at least one row")
        ring, ring_w, flag = buf.data_ptr(), buf_w.data_ptr(), drain.data_ptr()
    p_out = torch.empty_like(params)
    operands = [updates, params, p_out] + ([buf] if buf is not None else [])
    moments = any(r in MOMENT_RULES for r in registry)
    if moments:  # every lane writes m' and v' (an AXPY lane's through)
        m_out, v_out = torch.empty_like(m), torch.empty_like(v)
        operands += [m, v, m_out, v_out]
    else:  # no lane may move the moments: they stay the caller's
        m_out, v_out = m, v
    mv = [x.data_ptr() if moments else None for x in (m, v, m_out, v_out)]
    plan = launch_plan(device, G, P, updates, operands)
    with on_card(updates):
        stream = torch.cuda.current_stream(device).cuda_stream
        # (1 - beta) in double, rounded to float once, as the one-lane launch
        status = library().server_update_launch(
            updates.data_ptr(), updates.element_size(), weights.data_ptr(), G, K, ring, ring_w,
            Kb, flag, P, params.data_ptr(), params.element_size(), mv[0], mv[1],
            rule_idx.data_ptr(), 0, int(rnd), eta, beta1, 1.0 - beta1, beta2, 1.0 - beta2, tau,
            plan.vec, plan.runs, p_out.data_ptr(), mv[2], mv[3], stream,
        )
    check(status, "server_update_grid")
    return p_out, m_out, v_out


def server_update_grid(updates, weights, params, m, v, rule_idx, rnd, *, registry=ALL_RULES,
                       eta=1.0, beta1=0.9, beta2=0.99, tau=1e-3):
    """B3g: G lanes' fused server updates -> (params' (G, P) in the master
    dtype, m', v' (G, P) fp32).

    ``updates`` (G, K, P), ``weights`` (G, K), ``params`` / ``m`` / ``v``
    (G, P); ``rule_idx`` a (G,) int32 tensor on the rows' device, each
    lane's GLOBAL ``AGGREGATOR_ORDER`` index, within ``registry`` (the
    global indices any lane may hold; without a moment rule among them the
    moments come back as given, unread).  ``rnd`` is ignored.
    """
    if _device_of(updates) == "cpu":
        return server_update_grid_plain(updates, weights, params, m, v, rule_idx, rnd,
                                        registry=registry, eta=eta, beta1=beta1, beta2=beta2,
                                        tau=tau)
    out = _launch_grid(updates, weights, None, None, None, params, m, v, rule_idx, rnd,
                       registry, eta, beta1, beta2, tau)
    count_launch(__name__, "grid_launches")
    return out


def server_update_buffered_grid(updates, weights, buf, buf_w, params, m, v, rule_idx, rnd,
                                drain, *, registry=ALL_RULES, eta=1.0, beta1=0.9, beta2=0.99,
                                tau=1e-3):
    """B4g: ``server_update_grid`` with each lane's ``(Kb, P)`` ring: ``buf``
    (G, Kb, P) in the rows' dtype, ``buf_w`` (G, Kb) and ``drain`` a (G,)
    bool tensor on the rows' device (never read back to the host).  A lane
    whose ``drain`` is false is ``server_update_grid``'s on that lane."""
    if _device_of(updates) == "cpu":
        return server_update_buffered_grid_plain(
            updates, weights, buf, buf_w, params, m, v, rule_idx, rnd, drain,
            registry=registry, eta=eta, beta1=beta1, beta2=beta2, tau=tau)
    out = _launch_grid(updates, weights, buf, buf_w, drain, params, m, v, rule_idx, rnd,
                       registry, eta, beta1, beta2, tau)
    count_launch(__name__, "buffered_grid_launches")
    return out
