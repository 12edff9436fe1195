"""L-BFGS with a zoom linesearch, batched: the port of what
``tpu_pose/fitting/fit.py:_run_stage_lbfgs`` runs, ``optax.lbfgs()``
(optax 0.2.6), written out by hand in optax's order of operations:

1. ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``: a ring
   buffer of (Δparams, Δgradients, ρ) and the two-loop recursion; the
   initial inverse-Hessian scale is ⟨Δu, Δw⟩/‖Δu‖², on the very first
   step min(1, 1/‖g‖);
2. ``scale(-1)``;
3. ``scale_by_zoom_linesearch(max_linesearch_steps=20,
   initial_guess_strategy="one")``: Nocedal and Wright's interval search
   and zoom (Algorithms 3.5, 3.6) with the Hager–Zhang approximate
   decrease criterion, cubic and quadratic interpolation with their
   safeguards, and the fall-back to the best point of sufficient decrease.

The JAX package ``vmap``s a per-frame fit, so each sample has its own
memory, step size and linesearch ``while_loop``; under ``vmap`` the loop
runs until every sample is done and a done sample's state stops changing.
Here one backward of ``energy_fn(x).sum()`` per linesearch iteration
gives every sample its own value and gradient (the samples' energies are
independent), the linesearch state is (B,)-shaped, and ``torch.where``
updates only the samples still searching. A sample's result does not
depend on the others in its batch.

An export (``export.py``) runs the same arithmetic as loops on the
device: :func:`lbfgs_scan` is a ``scan`` over the steps whose body holds
the memory as (M, B, D) buffers in oldest-to-newest order, and its
linesearch is a ``while_loop`` with the eager loop's exit condition
(:func:`_zoom_linesearch_loop`). The eager loop and the loops' bodies share
:func:`_linesearch_iteration` and :func:`_precondition`, so a replayed
stage takes the eager stage's steps. ``COUNTS`` counts the eager loop
only.
"""

from __future__ import annotations

import torch

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
# scale_by_zoom_linesearch's defaults, as optax.lbfgs() leaves them.
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5      # the zoom's interval threshold
TOL = 0.0

# Work done since the last reset, for measurement: L-BFGS steps and
# energy evaluations of the linesearches (each summed over samples), the
# most linesearch evaluations one sample made in one step, and host reads.
COUNTS = {"steps": 0, "evaluations": 0, "max_step_evaluations": 0,
          "host_reads": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (NaN when there is none; the caller's bounds
    checks then reject it)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc ** 2 * v0 + (-(db ** 2)) * v1) / denom
    B = ((-(dc ** 3)) * v0 + db ** 3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo's criterion, or Hager and Zhang's approximate decrease once
    the value is within ``APPROX_DEC_RTOL`` of the initial one; the
    violation (≥ 0, NaN → inf)."""
    err = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - APPROX_DEC_RTOL * value_init.abs()
    err = torch.minimum(torch.maximum(approx, delta), err)
    err = torch.clamp_min(err, 0.0)
    return torch.where(torch.isnan(err), torch.inf, err)


def _curvature_error(slope, slope_init):
    err = torch.clamp_min(slope.abs() - CURV_RTOL * slope_init.abs(), 0.0)
    return torch.where(torch.isnan(err), torch.inf, err)


def _where(cond, new: dict, old: dict) -> dict:
    """Per-sample select of every field: ``new`` where ``cond``."""
    out = {}
    for k, v in old.items():
        c = cond[:, None] if v.dim() == 2 else cond
        out[k] = torch.where(c, new[k], v)
    return out


def _init_state(value: torch.Tensor, grad: torch.Tensor,
                slope: torch.Tensor) -> dict:
    zero = torch.zeros_like(value)
    false = torch.zeros_like(value, dtype=torch.bool)
    return dict(stepsize=zero, value=value, grad=grad, slope=slope,
                decrease_error=torch.full_like(value, torch.inf),
                curvature_error=torch.full_like(value, torch.inf),
                interval_found=false, done=false, failed=false,
                low=zero, value_low=value, slope_low=slope,
                high=zero, value_high=value, slope_high=slope,
                cubic_ref=zero, value_cubic_ref=value,
                safe_stepsize=zero, safe_value=value, safe_grad=grad)


def _flag(cond, like: torch.Tensor) -> torch.Tensor:
    """``cond`` (a Python bool, or a 0-d bool tensor inside a traced loop)
    as a tensor of ``like``'s shape."""
    if isinstance(cond, bool):
        return torch.full_like(like, cond, dtype=torch.bool)
    return cond.expand(like.shape)


def _linesearch_iteration(s: dict, it, value_and_grad, x, updates,
                          value_init, slope_init) -> dict:
    """Iteration ``it`` (an int, or a 0-d integer tensor inside a traced
    loop) of the zoom linesearch from state ``s``: every sample's next
    state, whether it is still searching or not (the caller keeps the
    finished samples' state)."""
    # The candidate: the interval search's next step size, or the zoom's
    # interpolated point once an interval is known.
    zero = torch.zeros_like(s["stepsize"])
    if isinstance(it, int):
        new_stepsize = (torch.ones_like(zero) if it == 0
                        else INCREASE_FACTOR * s["stepsize"])
    else:
        new_stepsize = torch.where(it == 0, torch.ones_like(zero),
                                   INCREASE_FACTOR * s["stepsize"])
    low, high = s["low"], s["high"]
    delta = (high - low).abs()
    left, right = torch.minimum(high, low), torch.maximum(high, low)
    cubic = _cubicmin(low, s["value_low"], s["slope_low"], high,
                      s["value_high"], s["cubic_ref"], s["value_cubic_ref"])
    use_cubic = (cubic > left + 0.2 * delta) & (cubic < right - 0.2 * delta)
    quad = _quadmin(low, s["value_low"], s["slope_low"], high,
                    s["value_high"])
    use_quad = ~use_cubic & (quad > left + 0.1 * delta) & (
        quad < right - 0.1 * delta)
    middle = torch.where(use_cubic, cubic, s["cubic_ref"])
    middle = torch.where(use_quad, quad, middle)
    middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0, middle)
    zoom = s["interval_found"]
    step = torch.where(zoom, middle, new_stepsize)

    v, g = value_and_grad(x + step[:, None] * updates)
    sl = _vdot(g, updates)
    dec = _decrease_error(step, v, sl, value_init, slope_init)
    curv = _curvature_error(sl, slope_init)
    err = torch.maximum(dec, curv)
    done = err <= TOL
    last = _flag(it + 1 >= MAX_LINESEARCH_STEPS, done)
    common = dict(stepsize=step, value=v, grad=g, slope=sl,
                  decrease_error=dec, curvature_error=curv, done=done)

    # Interval search (Algorithm 3.5).
    prev_step, prev_v, prev_sl = s["stepsize"], s["value"], s["slope"]
    safe = dec <= TOL
    set_high = (dec > 0.0) | ((v >= prev_v) & _flag(it > 0, done))
    set_low = (sl >= 0.0) & ~set_high
    search = dict(
        common,
        interval_found=set_high | set_low | done,
        failed=last & ~done,
        low=torch.where(set_low, step, prev_step),
        value_low=torch.where(set_low, v, prev_v),
        slope_low=torch.where(set_low, sl, prev_sl),
        high=torch.where(set_low, prev_step, step),
        value_high=torch.where(set_low, prev_v, v),
        slope_high=torch.where(set_low, prev_sl, sl),
        safe_stepsize=torch.where(safe, step, s["safe_stepsize"]),
        safe_value=torch.where(safe, v, s["safe_value"]),
        safe_grad=torch.where(safe[:, None], g, s["safe_grad"]))
    search["cubic_ref"] = search["low"]
    search["value_cubic_ref"] = search["value_low"]

    # Zoom (Algorithm 3.6).
    upd_safe = safe & (v < s["safe_value"])
    safe_step = torch.where(upd_safe, step, s["safe_stepsize"])
    to_middle = (dec > 0.0) | (v >= s["value_low"])
    to_low = (sl * (high - low) >= 0.0) & ~to_middle
    new_high = torch.where(to_low, low, torch.where(to_middle, step, high))
    new_vhigh = torch.where(to_low, s["value_low"], torch.where(
        to_middle, v, s["value_high"]))
    new_shigh = torch.where(to_low, s["slope_low"], torch.where(
        to_middle, sl, s["slope_high"]))
    ref_high = to_middle | to_low
    zoomed = dict(
        common, interval_found=s["interval_found"],
        failed=(last | ((delta <= STEPSIZE_PRECISION) & (safe_step > 0.0)))
        & ~done,
        low=torch.where(to_middle, low, step),
        value_low=torch.where(to_middle, s["value_low"], v),
        slope_low=torch.where(to_middle, s["slope_low"], sl),
        high=new_high, value_high=new_vhigh, slope_high=new_shigh,
        cubic_ref=torch.where(ref_high, high, low),
        value_cubic_ref=torch.where(ref_high, s["value_high"],
                                    s["value_low"]),
        safe_stepsize=safe_step,
        safe_value=torch.where(upd_safe, v, s["safe_value"]),
        safe_grad=torch.where(upd_safe[:, None], g, s["safe_grad"]))

    new = _where(zoom, zoomed, search)
    # A failed search falls back to the best point of sufficient
    # decrease, or stays put when every step left the domain.
    fall = new["failed"] & ((new["safe_stepsize"] > 0.0)
                            | torch.isinf(new["decrease_error"]))
    new.update(_where(fall, {"stepsize": new["safe_stepsize"],
                             "value": new["safe_value"],
                             "grad": new["safe_grad"]},
                      {"stepsize": new["stepsize"],
                       "value": new["value"], "grad": new["grad"]}))
    return new


def zoom_linesearch(value_and_grad, x: torch.Tensor, updates: torch.Tensor,
                    value: torch.Tensor, grad: torch.Tensor):
    """Step sizes (B,) along ``updates`` from ``x`` satisfying sufficient
    decrease and small curvature, per sample, with the value and gradient
    at the accepted points.

    The loop reads the device once per iteration, to stop when every
    sample is done: this is the eager fit's one host sync. Running all
    ``MAX_LINESEARCH_STEPS`` iterations every step instead would cost up
    to 20× the energy evaluations; the export form
    (:func:`_zoom_linesearch_loop`) stops on the same condition."""
    s = _init_state(value, grad, _vdot(updates, grad))
    value_init, slope_init = value, s["slope"]
    active = torch.ones_like(s["done"])
    n_active = value.shape[0]
    for it in range(MAX_LINESEARCH_STEPS):
        COUNTS["evaluations"] += n_active
        new = _linesearch_iteration(s, it, value_and_grad, x, updates,
                                    value_init, slope_init)
        s = _where(active, new, s)
        active = ~(s["done"] | s["failed"])
        n_active = int(active.sum())                 # the host sync
        COUNTS["host_reads"] += 1
        if n_active == 0:
            break
    COUNTS["max_step_evaluations"] = max(COUNTS["max_step_evaluations"],
                                         it + 1)
    return s["stepsize"], s["value"], s["grad"]


_STATE_KEYS = tuple(_init_state(torch.zeros(1), torch.zeros(1, 1),
                                torch.zeros(1)))


def _zoom_linesearch_loop(value_and_grad, x, updates, value, grad,
                          inputs: tuple):
    """:func:`zoom_linesearch` as a ``while_loop`` for an export: the same
    iterations (:func:`_linesearch_iteration`, the finished samples'
    state frozen) until no sample is searching or
    ``MAX_LINESEARCH_STEPS`` ran. ``value_and_grad(x, *inputs)``; every
    tensor the loop reads is passed in explicitly."""
    from torch._higher_order_ops.while_loop import while_loop_op
    s = _init_state(value, grad, _vdot(updates, grad))
    it = torch.zeros((), dtype=torch.int64, device=value.device)
    active = torch.ones_like(s["done"])

    def cond(it, active, *rest):
        return active.any() & (it < MAX_LINESEARCH_STEPS)

    def body(it, active, *rest):
        fields = rest[:len(_STATE_KEYS)]
        x, updates, value_init, slope_init, *inputs = rest[len(fields):]
        s = dict(zip(_STATE_KEYS, fields))
        new = _linesearch_iteration(
            s, it, lambda y: value_and_grad(y, *inputs), x, updates,
            value_init, slope_init)
        s = _where(active, new, s)
        return ((it + 1, ~(s["done"] | s["failed"]))
                + tuple(s[k] for k in _STATE_KEYS))

    out = while_loop_op(cond, body,
                        (it, active) + tuple(s[k] for k in _STATE_KEYS),
                        (x, updates, value, s["slope"]) + tuple(inputs))
    s = dict(zip(_STATE_KEYS, out[2:]))
    return s["stepsize"], s["value"], s["grad"]


def _precondition(grad, dw, du, rho, gamma, valid=None):
    """The two-loop recursion over the memory slots ``dw``, ``du``, ``rho``
    (sequences, oldest first). Eagerly they are the written slots; a slot
    never written would hold zeros and add exactly nothing, so it is left
    out. In the export form every slot is passed, with ``valid`` the
    0-d flags of the written ones: an unwritten slot leaves the vector as
    it is."""
    def keep(i, new, old):
        return new if valid is None else torch.where(valid[i], new, old)

    n = len(dw)
    vec, alphas = grad, [None] * n
    for i in reversed(range(n)):
        alphas[i] = rho[i] * _vdot(dw[i], vec)
        vec = keep(i, vec + (-alphas[i])[:, None] * du[i], vec)
    vec = gamma[:, None] * vec
    for i in range(n):
        beta = rho[i] * _vdot(du[i], vec)
        vec = keep(i, vec + (alphas[i] - beta)[:, None] * dw[i], vec)
    return vec


def value_and_grad_fn(energy_fn, mask: torch.Tensor | None = None):
    """``(x, *args) -> (energies, gradient)`` of ``energy_fn(x, *args)``
    with the coordinates where ``mask`` is 0 frozen: the energy sees
    ``x·mask + x.detach()·(1 − mask)``, so frozen coordinates get a zero
    gradient and the linesearch's directional derivatives stay
    consistent with it."""
    def value_and_grad(x, *args):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            xe = x if mask is None else x * mask + x.detach() * (1 - mask)
            e = energy_fn(xe, *args)
            (g,) = torch.autograd.grad(e.sum(), x)
        return e.detach(), g
    return value_and_grad


def _curvature_pair(x, prev_x, grad, prev_g):
    """The newest memory slot (Δparams, Δgradients, ρ) and the inverse
    Hessian scale ⟨Δu, Δw⟩/‖Δu‖²."""
    dw, du = x - prev_x, grad - prev_g
    curv = _vdot(du, dw)
    rho = torch.where(curv == 0.0, 0.0, 1.0 / curv)
    den = _vdot(du, du)
    return dw, du, rho, torch.where(den > 0.0, curv / den, 1.0)


def _first_scale(grad):
    """min(1, 1/‖g‖): the first step stays in a unit ball."""
    return torch.clamp(1.0 / torch.linalg.vector_norm(grad, dim=-1),
                       max=1.0)


def run_lbfgs(energy_fn, x: torch.Tensor, iters: int,
              mask: torch.Tensor | None = None, keep_history: bool = False,
              args: tuple = ()):
    """``iters`` L-BFGS steps on the flat parameters ``x`` (B, D) from
    fresh state. ``energy_fn(x, *args)`` gives the (B,) energies. ``mask``
    (D,) freezes coordinates as the JAX stage does
    (:func:`value_and_grad_fn`). Returns (x, the energy before each step
    when ``keep_history``)."""
    vg = value_and_grad_fn(energy_fn, mask)

    def value_and_grad(x):
        return vg(x, *args)

    # optax's value_and_grad_from_state evaluates when the stored value
    # is not finite. That holds for the fresh state only: afterwards the
    # stored value and gradient are those of the accepted point, which is
    # exactly the new parameters (x + stepsize·direction, the same
    # rounding), so re-evaluating would return the same numbers.
    value, grad = value_and_grad(x)
    b = x.shape[0]
    dw, du, rho = {}, {}, {}
    prev_x = prev_g = None
    hist = []
    with torch.no_grad():
        for k in range(iters):
            if keep_history:
                hist.append(value)
            if k == 0:
                gamma = _first_scale(grad)
            else:
                slot = (k - 1) % MEMORY_SIZE
                dw[slot], du[slot], rho[slot], gamma = _curvature_pair(
                    x, prev_x, grad, prev_g)
            n_mem = min(k, MEMORY_SIZE)
            slots = [(k + i) % MEMORY_SIZE
                     for i in range(MEMORY_SIZE - n_mem, MEMORY_SIZE)]
            direction = -1.0 * _precondition(
                grad, [dw[i] for i in slots], [du[i] for i in slots],
                [rho[i] for i in slots], gamma)
            stepsize, new_value, new_grad = zoom_linesearch(
                value_and_grad, x, direction, value, grad)
            prev_x, prev_g = x, grad
            x = x + stepsize[:, None] * direction
            value, grad = new_value, new_grad
            COUNTS["steps"] += b
    return x.detach(), hist


def lbfgs_scan(value_and_grad, x: torch.Tensor, iters: int,
               keep_history: bool, inputs: tuple):
    """:func:`run_lbfgs` as one ``scan`` over the steps, for an export;
    ``value_and_grad(x, *inputs)`` is the stage's recorded gradient graph
    (``fitting/fit.FitExport``). The scan carries x, the value, the
    gradient, the previous x and gradient and the memory as (M, B, D)
    buffers in oldest-to-newest order: each step after the first drops
    the oldest slot and appends the newest, and the slots not yet written
    (zeros) are flagged off, so the two-loop recursion visits the written
    slots in the eager loop's order. Each step's linesearch is
    :func:`_zoom_linesearch_loop`. Returns (x, its value and gradient,
    the history :func:`run_lbfgs` returns)."""
    from torch._higher_order_ops.scan import scan_op
    m = MEMORY_SIZE
    value, grad = value_and_grad(x, *inputs)

    def body(x, value, grad, prev_x, prev_g, dws, dus, rhos, k, *inputs):
        first = k == 0
        dw, du, rho, gamma = _curvature_pair(x, prev_x, grad, prev_g)
        gamma = torch.where(first, _first_scale(grad), gamma)
        dws = torch.where(first, dws, torch.cat([dws[1:], dw[None]]))
        dus = torch.where(first, dus, torch.cat([dus[1:], du[None]]))
        rhos = torch.where(first, rhos, torch.cat([rhos[1:], rho[None]]))
        n_mem = torch.clamp(k, max=m)
        valid = [n_mem >= m - i for i in range(m)]
        direction = -1.0 * _precondition(grad, dws.unbind(0), dus.unbind(0),
                                         rhos.unbind(0), gamma, valid)
        stepsize, new_value, new_grad = _zoom_linesearch_loop(
            value_and_grad, x, direction, value, grad, inputs)
        new_x = x + stepsize[:, None] * direction
        return ((new_x, new_value, new_grad, x.clone(), grad.clone(), dws,
                 dus, rhos) + ((value.clone(),) if keep_history else ()))

    b, d = x.shape
    mem = x.new_zeros((m, b, d))
    steps = torch.arange(iters, device=x.device)
    # A scan's carry keeps its initial value's strides.
    x = x.clone(memory_format=torch.contiguous_format)
    x, value, grad, *rest = scan_op(
        body, [x, value, grad, torch.zeros_like(x), torch.zeros_like(grad),
               mem, mem.clone(), x.new_zeros((m, b))], [steps],
        tuple(inputs))
    return x, value, grad, (list(rest[-1].unbind(0)) if keep_history
                            else [])
