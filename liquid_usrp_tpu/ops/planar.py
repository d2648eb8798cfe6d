"""Planar-complex transform: run complex-IQ pipelines as real-only XLA.

``planarize(fn)`` rewrites any jittable function over complex64/128
arrays into an equivalent function over *planar* values — pairs of real
I/Q planes — by interpreting its jaxpr with per-primitive planar rules.
No complex dtype ever reaches the backend.

Why this exists: the planar rules express every DFT in the signal path
as real matmuls (direct DFT for small transforms, two-stage Cooley-Tukey
with ``sqrt(N) x sqrt(N)`` factor matrices for large ones), and planar
pairs can carry reduced-precision (bf16) planes, which complex64 cannot.
It is a library path kept for that A/B against the complex pipeline;
the DFT matmuls run at ``Precision.HIGHEST`` so a float32 matmul never
silently drops to TF32 on a GPU.

The transform covers the whole framework surface by construction: it
recurses through ``jit``/``scan``/``cond``/``while`` and custom-derivative
call primitives, so every pipeline built from the house
``step(state, block)`` ops planarizes without modification.  Results are
float-accurate to re-association (the decode chain's integer outputs —
payload bytes, CRC flags, fingerprints — are asserted exactly equal to
the complex path in tests/test_planar.py).

Reference scope note: the reference operates on interleaved complex
float32 throughout (``uhd::io_type_t::COMPLEX_FLOAT32``,
liquid-usrp lib/ofdmtxrx.cc:96); the planar representation is a
real-only re-expression of that stream format.
"""
from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, tree_util
from jax.extend import core

__all__ = ["Planar", "planarize", "to_planar", "from_planar"]


@tree_util.register_pytree_node_class
class Planar:
    """A complex array represented as two real planes (re, im)."""

    __slots__ = ("re", "im")

    def __init__(self, re, im):
        self.re = re
        self.im = im

    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return np.shape(self.re)

    def __repr__(self):
        return f"Planar(re={self.re!r}, im={self.im!r})"


def _is_planar_leaf(x) -> bool:
    return isinstance(x, Planar)


def to_planar(tree):
    """Replace every complex leaf with a :class:`Planar` of real planes.

    Accepts NumPy or JAX leaves; complex NumPy leaves become NumPy planes.
    """
    def conv(x):
        if isinstance(x, np.ndarray) and np.issubdtype(x.dtype,
                                                       np.complexfloating):
            f = np.float32 if x.dtype == np.complex64 else np.float64
            return Planar(np.ascontiguousarray(x.real, f),
                          np.ascontiguousarray(x.imag, f))
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype,
                                                  jnp.complexfloating):
            return Planar(jnp.real(x), jnp.imag(x))
        return x
    return tree_util.tree_map(conv, tree)


def from_planar(tree):
    """Inverse of :func:`to_planar` (host-side: combines planes)."""
    def conv(x):
        if isinstance(x, Planar):
            re = np.asarray(x.re)
            im = np.asarray(x.im)
            c = np.complex64 if re.dtype != np.float64 else np.complex128
            return (re.astype(np.float32) if c == np.complex64 else re) \
                + 1j * im.astype(re.dtype)
        return x
    return tree_util.tree_map(conv, tree, is_leaf=_is_planar_leaf)


def _complex_dtype_of(plane_dtype):
    return jnp.complex128 if plane_dtype == jnp.float64 else jnp.complex64


def _plane_dtype_of(complex_dtype):
    return jnp.float64 if complex_dtype == jnp.complex128 else jnp.float32


def _is_cplx_aval(aval) -> bool:
    return (getattr(aval, "dtype", None) is not None
            and jnp.issubdtype(aval.dtype, jnp.complexfloating))


def _split_const(val):
    """Convert a (possibly complex) constant/literal to planar form."""
    a = np.asarray(val)
    if np.issubdtype(a.dtype, np.complexfloating):
        f = np.float32 if a.dtype == np.complex64 else np.float64
        return (jnp.asarray(a.real.astype(f)), jnp.asarray(a.imag.astype(f)))
    return val


def _pair(v):
    return isinstance(v, tuple)


# ---------------------------------------------------------------------------
# planar DFT: direct matmul for small n, two-stage Cooley-Tukey above

_DFT_DIRECT_MAX = 512


@functools.lru_cache(maxsize=None)
def _dft_mats_np(n: int, dtype_name: str):
    k = np.arange(n)
    th = 2.0 * np.pi * np.outer(k, k) / n
    dt = np.dtype(dtype_name)
    return np.cos(th).astype(dt), (-np.sin(th)).astype(dt)


@functools.lru_cache(maxsize=None)
def _twiddle_np(n1: int, n2: int, dtype_name: str):
    th = 2.0 * np.pi * np.outer(np.arange(n1), np.arange(n2)) / (n1 * n2)
    dt = np.dtype(dtype_name)
    return np.cos(th).astype(dt), (-np.sin(th)).astype(dt)


def _dft_mats(n, dtype_name):
    # NumPy cached; jnp.asarray at trace time (a cached traced array would
    # leak a tracer across jit scopes — CLAUDE.md closure-constant rule)
    wr, wi = _dft_mats_np(n, dtype_name)
    return jnp.asarray(wr), jnp.asarray(wi)


def _twiddle(n1, n2, dtype_name):
    tr, ti = _twiddle_np(n1, n2, dtype_name)
    return jnp.asarray(tr), jnp.asarray(ti)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _fft_fwd(xr, xi, n: int):
    """Planar forward DFT over the last axis (length ``n``)."""
    dt = np.dtype(xr.dtype).name
    if n <= _DFT_DIRECT_MAX:
        wr, wi = _dft_mats(n, dt)
        # y[k] = sum_t x[t] W[k,t];  W symmetric so W.T == W
        mm = functools.partial(jnp.matmul, precision=lax.Precision.HIGHEST)
        return mm(xr, wr) - mm(xi, wi), mm(xr, wi) + mm(xi, wr)
    if n & (n - 1):
        raise NotImplementedError(
            f"planar FFT: non-power-of-two length {n} > {_DFT_DIRECT_MAX}")
    m = n.bit_length() - 1
    n1 = 1 << (m // 2)
    n2 = n // n1
    # x[n1*t2 + t1] -> [..., t2, t1] -> [..., t1, t2]
    lead = xr.shape[:-1]
    xr = jnp.swapaxes(xr.reshape(*lead, n2, n1), -1, -2)
    xi = jnp.swapaxes(xi.reshape(*lead, n2, n1), -1, -2)
    ar, ai = _fft_fwd(xr, xi, n2)                 # DFT over t2 -> [.., t1, k2]
    tr, ti = _twiddle(n1, n2, dt)                 # e^{-2i pi t1 k2 / n}
    br, bi = _cmul(ar, ai, tr, ti)
    # DFT over t1: move t1 last, transform, move back
    br = jnp.swapaxes(br, -1, -2)                 # [.., k2, t1]
    bi = jnp.swapaxes(bi, -1, -2)
    cr, ci = _fft_fwd(br, bi, n1)                 # [.., k2, k1]
    cr = jnp.swapaxes(cr, -1, -2)                 # [.., k1, k2]
    ci = jnp.swapaxes(ci, -1, -2)
    # X[n2*k1 + k2] = C[k1, k2]
    return cr.reshape(*lead, n), ci.reshape(*lead, n)


def _fft_planar(xr, xi, fft_type, n: int):
    name = getattr(fft_type, "name", str(fft_type))
    if name == "FFT":
        return _fft_fwd(xr, xi, n)
    if name == "IFFT":
        yr, yi = _fft_fwd(xr, -xi, n)
        s = np.asarray(1.0 / n, xr.dtype)
        return yr * s, -(yi * s)
    raise NotImplementedError(f"planar FFT type {name}")


# ---------------------------------------------------------------------------
# primitive rules

# structural/linear primitives: apply the primitive independently per plane
# (index/predicate/real operands are passed through unchanged)
_PER_PLANE = {
    "broadcast_in_dim", "concatenate", "copy", "cumsum", "dynamic_slice",
    "dynamic_update_slice", "expand_dims", "gather", "pad", "reduce_sum",
    "reshape", "rev", "scatter", "scatter-add", "select_n", "slice",
    "squeeze", "sub", "add", "neg", "transpose", "stop_gradient",
    "reduce_precision", "optimization_barrier",
}

_CALL_PRIMS = {"jit", "pjit", "closed_call", "core_call", "custom_jvp_call",
               "custom_vjp_call", "custom_vjp_call_jaxpr", "remat",
               "checkpoint"}


def _sub_closed_jaxpr(eqn):
    p = eqn.params
    for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
        if key in p and p[key] is not None:
            sub = p[key]
            if isinstance(sub, core.Jaxpr):
                return core.ClosedJaxpr(sub, ())
            return sub
    raise NotImplementedError(
        f"call primitive {eqn.primitive.name}: no sub-jaxpr found "
        f"(params: {list(p)})")


def _out_mask(avals):
    return [_is_cplx_aval(a) for a in avals]


def _flatten_by_mask(vals):
    """[val|pair] -> flat list of arrays + mask (True where pair)."""
    flat, mask = [], []
    for v in vals:
        if _pair(v):
            flat.extend(v)
            mask.append(True)
        else:
            flat.append(v)
            mask.append(False)
    return flat, mask


def _unflatten_by_mask(flat, mask):
    out, i = [], 0
    for m in mask:
        if m:
            out.append((flat[i], flat[i + 1]))
            i += 2
        else:
            out.append(flat[i])
            i += 1
    assert i == len(flat)
    return out


def _clean_real_params(prim_name, params):
    """Map complex dtype params to their plane dtype."""
    p = dict(params)
    for key in ("new_dtype", "preferred_element_type", "dtype"):
        if key in p and p[key] is not None \
                and jnp.issubdtype(p[key], jnp.complexfloating):
            p[key] = _plane_dtype_of(p[key])
    return p


def _eval_eqn(eqn, vals):
    """Evaluate one jaxpr eqn on planar values; returns list of outputs."""
    prim = eqn.primitive
    name = prim.name
    params = eqn.params

    if name in _CALL_PRIMS:
        sub = _sub_closed_jaxpr(eqn)
        outs = planar_eval_jaxpr(sub.jaxpr, sub.consts, *vals)
        return outs

    if name == "scan":
        return _eval_scan(eqn, vals)
    if name == "cond":
        return _eval_cond(eqn, vals)
    if name == "while":
        return _eval_while(eqn, vals)

    any_cplx_in = any(_pair(v) for v in vals)
    any_cplx_out = any(_is_cplx_aval(v.aval) for v in eqn.outvars)

    if not any_cplx_in and not any_cplx_out:
        out = prim.bind(*vals, **params)
        return list(out) if prim.multiple_results else [out]

    # ---- arithmetic rules ----
    if name in ("add", "sub"):
        (ar, ai), (br, bi) = _as_pair(vals[0]), _as_pair(vals[1])
        if name == "add":
            return [(ar + br, ai + bi)]
        return [(ar - br, ai - bi)]
    if name == "neg":
        ar, ai = _as_pair(vals[0])
        return [(-ar, -ai)]
    if name == "mul":
        (ar, ai), (br, bi) = _as_pair(vals[0]), _as_pair(vals[1])
        return [_cmul(ar, ai, br, bi)]
    if name == "div":
        (ar, ai), (br, bi) = _as_pair(vals[0]), _as_pair(vals[1])
        d = br * br + bi * bi
        return [((ar * br + ai * bi) / d, (ai * br - ar * bi) / d)]
    if name == "conj":
        ar, ai = _as_pair(vals[0])
        return [(ar, -ai)]
    if name == "abs":
        ar, ai = _as_pair(vals[0])
        return [jnp.sqrt(ar * ar + ai * ai)]
    if name == "real":
        return [_as_pair(vals[0])[0]]
    if name == "imag":
        return [_as_pair(vals[0])[1]]
    if name == "complex":
        return [(vals[0], vals[1])]
    if name == "exp":
        ar, ai = _as_pair(vals[0])
        m = jnp.exp(ar)
        return [(m * jnp.cos(ai), m * jnp.sin(ai))]
    if name == "integer_pow":
        y = int(params["y"])
        if y < 0:
            raise NotImplementedError("planar integer_pow with y<0")
        rr, ri = jnp.ones_like(vals[0][0]), jnp.zeros_like(vals[0][1])
        br, bi = _as_pair(vals[0])
        for _ in range(y):
            rr, ri = _cmul(rr, ri, br, bi)
        return [(rr, ri)]
    if name in ("eq", "ne"):
        (ar, ai), (br, bi) = _as_pair(vals[0]), _as_pair(vals[1])
        eq = (ar == br) & (ai == bi)
        return [eq if name == "eq" else ~eq]
    if name == "convert_element_type":
        new = params["new_dtype"]
        if jnp.issubdtype(new, jnp.complexfloating):
            f = _plane_dtype_of(new)
            if _pair(vals[0]):
                ar, ai = vals[0]
                return [(ar.astype(f), ai.astype(f))]
            v = jnp.asarray(vals[0]).astype(f)
            return [(v, jnp.zeros_like(v))]
        # complex -> real: XLA drops the imaginary part
        ar, _ = _as_pair(vals[0])
        return [ar.astype(new)]
    if name == "dot_general":
        p = _clean_real_params(name, params)
        (ar, ai), (br, bi) = _as_pair(vals[0]), _as_pair(vals[1])
        f = lambda x, y: prim.bind(x, y, **p)      # noqa: E731
        return [(f(ar, br) - f(ai, bi), f(ar, bi) + f(ai, br))]
    if name == "fft":
        n = params["fft_lengths"]
        if len(n) != 1:
            raise NotImplementedError("planar FFT: only 1-D transforms")
        ar, ai = _as_pair(vals[0])
        return [_fft_planar(ar, ai, params["fft_type"], n[0])]

    # ---- structural per-plane rules ----
    if name in _PER_PLANE or not any_cplx_out:
        p = _clean_real_params(name, params)
        outs_per_plane = []
        for plane in (0, 1):
            args = [v[plane] if _pair(v) else v for v in vals]
            out = prim.bind(*args, **p)
            outs_per_plane.append(
                list(out) if prim.multiple_results else [out])
        res = []
        for o0, o1, ov in zip(outs_per_plane[0], outs_per_plane[1],
                              eqn.outvars):
            res.append((o0, o1) if _is_cplx_aval(ov.aval) else o0)
        return res

    raise NotImplementedError(
        f"planar rule missing for primitive '{name}' "
        f"(in dtypes: {[getattr(v.aval, 'dtype', None) for v in eqn.invars]})")


def _as_pair(v):
    if _pair(v):
        return v
    # real value used where complex expected (shouldn't happen: jaxprs
    # insert explicit converts) — promote defensively
    return (v, jnp.zeros_like(v))


def _eval_scan(eqn, vals):
    p = eqn.params
    closed = p["jaxpr"]
    nc, ncar = p["num_consts"], p["num_carry"]
    consts, carry, xs = vals[:nc], vals[nc:nc + ncar], vals[nc + ncar:]
    carry_flat, carry_mask = _flatten_by_mask(carry)
    xs_flat, xs_mask = _flatten_by_mask(xs)
    n_out = len(closed.jaxpr.outvars)
    ys_avals = [v.aval for v in closed.jaxpr.outvars[ncar:]]
    ys_mask = _out_mask(ys_avals)

    def body(cflat, xflat):
        c = _unflatten_by_mask(list(cflat), carry_mask)
        x = _unflatten_by_mask(list(xflat), xs_mask)
        outs = planar_eval_jaxpr(closed.jaxpr, closed.consts,
                                 *consts, *c, *x)
        assert len(outs) == n_out
        oc_flat, oc_mask = _flatten_by_mask(outs[:ncar])
        assert oc_mask == carry_mask, "carry planar structure changed"
        oy_flat, oy_mask = _flatten_by_mask(outs[ncar:])
        assert oy_mask == ys_mask
        return tuple(oc_flat), tuple(oy_flat)

    final_c, ys = lax.scan(body, tuple(carry_flat), tuple(xs_flat),
                           length=p["length"], reverse=p["reverse"],
                           unroll=p.get("unroll", 1))
    return (_unflatten_by_mask(list(final_c), carry_mask)
            + _unflatten_by_mask(list(ys), ys_mask))


def _eval_cond(eqn, vals):
    branches = eqn.params["branches"]
    idx, args = vals[0], vals[1:]
    args_flat, args_mask = _flatten_by_mask(args)
    out_avals = [v.aval for v in branches[0].jaxpr.outvars]
    omask = _out_mask(out_avals)

    def make(br):
        def run(*flat):
            a = _unflatten_by_mask(list(flat), args_mask)
            outs = planar_eval_jaxpr(br.jaxpr, br.consts, *a)
            oflat, om = _flatten_by_mask(outs)
            assert om == omask, "cond branches disagree on planar structure"
            return tuple(oflat)
        return run

    res = lax.switch(idx, [make(b) for b in branches], *args_flat)
    return _unflatten_by_mask(list(res), omask)


def _eval_while(eqn, vals):
    p = eqn.params
    cj, bj = p["cond_jaxpr"], p["body_jaxpr"]
    cn, bn = p["cond_nconsts"], p["body_nconsts"]
    cconsts, bconsts = vals[:cn], vals[cn:cn + bn]
    carry = vals[cn + bn:]
    c_flat, c_mask = _flatten_by_mask(carry)

    def cond_fn(flat):
        a = _unflatten_by_mask(list(flat), c_mask)
        (r,) = planar_eval_jaxpr(cj.jaxpr, cj.consts, *cconsts, *a)
        return r

    def body_fn(flat):
        a = _unflatten_by_mask(list(flat), c_mask)
        outs = planar_eval_jaxpr(bj.jaxpr, bj.consts, *bconsts, *a)
        oflat, om = _flatten_by_mask(outs)
        assert om == c_mask
        return tuple(oflat)

    res = lax.while_loop(cond_fn, body_fn, tuple(c_flat))
    return _unflatten_by_mask(list(res), c_mask)


def planar_eval_jaxpr(jaxpr: core.Jaxpr, consts, *args):
    """Interpret ``jaxpr`` with complex values carried as (re, im) pairs."""
    env: dict[Any, Any] = {}

    def read(v):
        if isinstance(v, core.Literal):
            return _split_const(v.val)
        return env[v]

    def write(v, val):
        env[v] = val

    for var, c in zip(jaxpr.constvars, consts):
        write(var, _split_const(c))
    assert len(jaxpr.invars) == len(args), (
        f"jaxpr expects {len(jaxpr.invars)} args, got {len(args)}")
    for var, a in zip(jaxpr.invars, args):
        write(var, a)

    for eqn in jaxpr.eqns:
        vals = [read(v) for v in eqn.invars]
        outs = _eval_eqn(eqn, vals)
        assert len(outs) == len(eqn.outvars), (
            f"{eqn.primitive.name}: {len(outs)} outs for "
            f"{len(eqn.outvars)} outvars")
        for var, o in zip(eqn.outvars, outs):
            write(var, o)

    return [read(v) for v in jaxpr.outvars]


def _leaf_aval(leaf):
    if isinstance(leaf, Planar):
        re = leaf.re
        dt = getattr(re, "dtype", None) or np.asarray(re).dtype
        return jax.ShapeDtypeStruct(
            np.shape(re), _complex_dtype_of(np.dtype(dt)))
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return jax.ShapeDtypeStruct(tuple(leaf.shape), leaf.dtype)
    a = np.asarray(leaf)
    return jax.ShapeDtypeStruct(a.shape, a.dtype)


def planarize(fn):
    """Transform ``fn`` (complex-array pipeline) into its planar form.

    The returned function takes/returns the same pytrees with every
    complex leaf replaced by a :class:`Planar`; convert inputs with
    :func:`to_planar`.  Jit the result — tracing re-derives the complex
    jaxpr on every call.
    """
    @functools.wraps(fn)
    def planar_fn(*pargs):
        leaves, in_tree = tree_util.tree_flatten(
            pargs, is_leaf=_is_planar_leaf)
        avals = [_leaf_aval(l) for l in leaves]
        aval_args = tree_util.tree_unflatten(in_tree, avals)
        closed, out_shape = jax.make_jaxpr(fn, return_shape=True)(*aval_args)
        vals = [(l.re, l.im) if isinstance(l, Planar) else l for l in leaves]
        outs = planar_eval_jaxpr(closed.jaxpr, closed.consts, *vals)
        out_leaves = [Planar(*o) if _pair(o) else o for o in outs]
        out_tree = tree_util.tree_structure(out_shape)
        return tree_util.tree_unflatten(out_tree, out_leaves)

    return planar_fn
