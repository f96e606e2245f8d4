"""The port's Tensor and its framework core against the JAX package's, on
the CPU (`set_device("cpu")`):

  * the dtype canonicalisation of the JAX package's x64-off mode, probe by
    probe (to_tensor of int64 / float64 data and of dtype='int64',
    arange, argmax, topk's indices, nonzero, a sum over bool);
  * the creation functions (dtypes, shapes, values where they are not
    random), the default dtype, set_device / get_device / places, and
    that the default place (the card) raises without CUDA;
  * the Tensor's method names equal the JAX Tensor's after
    `_install_methods`, less the deferred ops' methods; the operators
    (scalar operands included) and indexing;
  * autograd: backward and its accumulation, grad with create_graph (a
    second derivative), no_grad / enable_grad / set_grad_enabled, hooks,
    retain_graph, clear_grad / clear_gradient, stop_gradient's rules;
  * the in-place rules: a non-leaf that needs grad refuses, a leaf that
    needs grad takes __setitem__ and the in-place methods and keeps its
    grad;
  * SelectedRows and its four functions; the Generator's keys and state
    round trips; FLAGS_check_nan_inf.
"""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place
from paddle_tpu_torch.ops.impl_extra import DEFERRED

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    saved = place._expected_place
    tp.set_device("cpu")
    yield
    place._expected_place = saved


def _name(dt):
    return tp.core.dtype.dtype_name(dt)


def _jname(dt):
    return jp.core.dtype.dtype_name(dt)


def _same(ours, ref, rtol=1e-6, atol=1e-6):
    assert _name(ours.dtype) == _jname(ref.dtype)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=rtol,
                               atol=atol)


# ------------------------------------------------------------ dtypes

PROBES = {
    "int64 array": lambda P: P.to_tensor(np.arange(3, dtype=np.int64)),
    "float64 array": lambda P: P.to_tensor(np.ones(2)),
    "dtype int64": lambda P: P.to_tensor([1], dtype="int64"),
    "python ints": lambda P: P.to_tensor([1, 2]),
    "python floats": lambda P: P.to_tensor([1.5]),
    "bool": lambda P: P.to_tensor([True, False]),
    "arange": lambda P: P.arange(5),
    "arange float": lambda P: P.arange(0.0, 2.0, 0.5),
    "argmax": lambda P: P.argmax(P.to_tensor([1.0, 3.0, 2.0])),
    "topk indices": lambda P: P._C_ops.topk(
        P.to_tensor([1.0, 3.0, 2.0]), 2)[1],
    "nonzero": lambda P: P.nonzero(P.to_tensor([0, 1, 1])),
    "sum over bool": lambda P: P.sum(P.to_tensor([True, True, False])),
    "cast int64": lambda P: P.cast(P.to_tensor([1.5]), "int64"),
    "astype float64": lambda P: P.to_tensor([1]).astype("float64"),
    "int tensor + 1.5": lambda P: P.to_tensor([1, 2]) + 1.5,
    "int tensor / int": lambda P: P.to_tensor([1, 2]) / 2,
    "float16 + 2": lambda P: P.to_tensor(np.ones(2, np.float16)) + 2,
    "int8 + 100": lambda P: P.to_tensor(np.ones(2, np.int8)) + 100,
    "mean of ints": lambda P: P.mean(P.to_tensor([1, 2])),
    "numel": lambda P: P.numel(P.to_tensor([1, 2])),
    "shape": lambda P: P.shape(P.to_tensor(np.ones((2, 3)))),
}


@pytest.mark.parametrize("probe", list(PROBES))
def test_dtype_canonicalisation_follows_jax(probe):
    ours, ref = PROBES[probe](tp), PROBES[probe](jp)
    _same(ours, ref)


def test_dtype_names_and_aliases():
    for spec in ("float", "double", "half", "int", "long", "bf16", "fp16",
                 "fp32", "fp64", "bool", "uint8", "int16", "complex128"):
        assert _name(tp.core.dtype.to_torch_dtype(spec)) == _jname(
            jp.core.dtype.to_jax_dtype(spec))
    assert tp.core.dtype.to_torch_dtype(np.float64) == torch.float32
    assert tp.core.dtype.to_torch_dtype(tp.int64) == torch.int32
    assert tp.core.dtype.to_torch_dtype(None) is None


# ------------------------------------------------------------ creation

CREATIONS = {
    "zeros": lambda P: P.zeros([2, 3]),
    "ones int": lambda P: P.ones([2], dtype="int64"),
    "full": lambda P: P.full([2, 2], 1.5),
    "empty": lambda P: P.empty([3]),
    "linspace": lambda P: P.linspace(0, 1, 5),
    "eye": lambda P: P.eye(3, 4),
    "zeros_like": lambda P: P.zeros_like(P.to_tensor([[1, 2]]), "float32"),
    "ones_like": lambda P: P.ones_like(P.to_tensor([1.5])),
    "full_like": lambda P: P.full_like(P.to_tensor([1, 2]), 7),
    "empty_like": lambda P: P.empty_like(P.to_tensor([1.0])),
    "assign": lambda P: P.assign(P.to_tensor([1.0, 2.0])),
    "clone": lambda P: P.clone(P.to_tensor([1.0, 2.0])),
    "increment": lambda P: P.increment(P.to_tensor([1.0]), 2.0),
    "meshgrid": lambda P: P.meshgrid([P.to_tensor([1.0, 2.0]),
                                      P.to_tensor([3.0])])[0],
}


@pytest.mark.parametrize("name", list(CREATIONS))
def test_creation_follows_jax(name):
    _same(CREATIONS[name](tp), CREATIONS[name](jp))


RANDOM = {
    "rand": lambda P: P.rand([3, 4]),
    "randn": lambda P: P.randn([2, 2], dtype="float16"),
    "uniform": lambda P: P.uniform([5], min=2.0, max=3.0),
    "normal": lambda P: P.normal(1.0, 2.0, [4]),
    "randint": lambda P: P.randint(0, 5, [6]),
    "randperm": lambda P: P.randperm(7),
    "bernoulli": lambda P: P.bernoulli(P.full([4], 0.5)),
    "multinomial": lambda P: P.multinomial(P.to_tensor([0.2, 0.8]), 3),
}


@pytest.mark.parametrize("name", list(RANDOM))
def test_random_creation_takes_jax_dtypes_and_is_seeded(name):
    jp.seed(3)
    ref = RANDOM[name](jp)
    tp.seed(3)
    ours = RANDOM[name](tp)
    tp.seed(3)
    again = RANDOM[name](tp)
    assert (_name(ours.dtype), ours.shape) == (_jname(ref.dtype), ref.shape)
    np.testing.assert_array_equal(ours.numpy(), again.numpy())
    if name == "uniform":
        assert ((ours.numpy() >= 2.0) & (ours.numpy() < 3.0)).all()
    if name == "randperm":
        assert sorted(ours.tolist()) == list(range(7))


def test_default_dtype_follows_jax():
    assert tp.get_default_dtype() == jp.get_default_dtype() == "float32"
    try:
        tp.set_default_dtype("float16")
        jp.set_default_dtype("float16")
        assert tp.get_default_dtype() == jp.get_default_dtype() == "float16"
        assert _name(tp.zeros([1]).dtype) == _jname(jp.zeros([1]).dtype)
    finally:
        tp.set_default_dtype("float32")
        jp.set_default_dtype("float32")


# ------------------------------------------------------------ places

def test_places_and_set_device():
    assert tp.get_device() == "cpu:0"
    p = tp.set_device("gpu:1")
    assert isinstance(p, tp.CUDAPlace) and p == tp.CUDAPlace(1)
    assert tp.get_device() == "gpu:1"
    assert tp.set_device("cuda").backend == "gpu"
    other = tp.set_device("xpu:2")
    assert other.backend == "xpu" and tp.get_device() == "xpu:2"
    with pytest.raises(ValueError, match="'gpu' or 'cpu'"):
        tp.zeros([1])
    assert tp.set_device("cpu") == tp.CPUPlace(0)
    assert tp.device_count("cpu") == 1
    assert tp.to_tensor([1.0]).place == tp.CPUPlace(0)
    assert hash(tp.CPUPlace(0)) == hash(tp.CPUPlace(0))


def test_the_default_place_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    place._expected_place = None
    assert tp.expected_place() == tp.CUDAPlace(0)
    assert tp.get_device() == "gpu:0"
    for make in (lambda: tp.to_tensor([1.0]), lambda: tp.zeros([2]),
                 lambda: tp.rand([2]), lambda: tp._C_ops.ones([2])):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make()
    # an op on tensors the caller placed runs where they are
    tp.set_device("cpu")
    x = tp.to_tensor([1.0])
    place._expected_place = None
    assert (x + x).place == tp.CPUPlace(0)


# ------------------------------------------------------------ the Tensor

def _jax_tensor_methods():
    """The JAX Tensor's public names after `_install_methods` (its class
    body read from the source, not from the live class: the JAX package
    binds more methods afterwards, in extras)."""
    src = open(jp.core.tensor.__file__).read()
    cls = next(n for n in ast.parse(src).body
               if isinstance(n, ast.ClassDef) and n.name == "Tensor")
    names = set()
    for node in cls.body:
        if isinstance(node, ast.FunctionDef):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__slots__":
                    names.update(e.value for e in node.value.elts)
                elif isinstance(t, ast.Name):
                    names.add(t.id)
    body = set(names)
    for name, op in jp._OPS.items():
        if op.method and not name.startswith("_") and name not in body:
            names.add(name)
            if op.inplace:
                names.add(op.inplace)
    return {n for n in names if not n.startswith("_")}


def test_tensor_method_names_equal_the_jax_tensors():
    ours = {n for n in dir(tp.Tensor) if not n.startswith("_")}
    want = _jax_tensor_methods() - set(DEFERRED)
    assert ours == want, (sorted(ours - want), sorted(want - ours))


OPERATORS = {
    "add": lambda a, b: a + b, "radd": lambda a, b: 2.0 + a,
    "sub": lambda a, b: a - b, "rsub": lambda a, b: 1.0 - a,
    "mul": lambda a, b: a * b, "rmul": lambda a, b: 3 * a,
    "truediv": lambda a, b: a / b, "rtruediv": lambda a, b: 1.0 / b,
    "floordiv": lambda a, b: a // b, "mod": lambda a, b: a % b,
    "pow": lambda a, b: b ** 2, "rpow": lambda a, b: 2.0 ** a,
    "matmul": lambda a, b: a @ b.T, "neg": lambda a, b: -a,
    "abs": lambda a, b: abs(a), "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != 1.0, "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b, "gt": lambda a, b: a > 0.5,
    "ge": lambda a, b: a >= b, "invert": lambda a, b: ~(a > b),
    "getitem": lambda a, b: a[1], "slice": lambda a, b: a[:, 1:3],
    "negative step": lambda a, b: a[::-1, ::-2],
    "ellipsis": lambda a, b: a[..., None, 0],
    "list index": lambda a, b: a[[1, 0]],
    "tensor index": lambda a, b: a[b > 1.0],
    "T": lambda a, b: a.T, "method": lambda a, b: a.exp().sum(axis=1),
    "astype": lambda a, b: a.astype("int32"),
}


@pytest.mark.parametrize("op", list(OPERATORS))
def test_operators_follow_jax(op):
    rng = np.random.default_rng(1)
    a = rng.uniform(0.5, 2, (2, 3)).astype(np.float32)
    b = rng.uniform(0.5, 2, (2, 3)).astype(np.float32)
    ours = OPERATORS[op](tp.to_tensor(a), tp.to_tensor(b))
    ref = OPERATORS[op](jp.to_tensor(a), jp.to_tensor(b))
    _same(ours, ref)


def test_tensor_basics():
    x = tp.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert (x.shape, x.ndim, x.size, x.numel(), len(x)) == ([2, 3], 2, 6,
                                                            6, 2)
    assert x.tolist() == [[0, 1, 2], [3, 4, 5]] and x[1, 2].item() == 5
    assert float(x[0, 1]) == 1.0 and int(x[1, 0]) == 3 and bool(x[0, 1])
    assert [r.shape for r in x] == [[3], [3]]
    assert x.is_leaf and x.stop_gradient and x.is_contiguous()
    assert x.contiguous() is x and x.pin_memory() is x
    assert x.cpu().place == tp.CPUPlace(0)
    assert _name(x.to("cpu", "float16").dtype) == "float16"
    assert "Tensor(shape=[2, 3], dtype=float32" in repr(x)
    assert x.detach().numpy().tolist() == x.tolist()
    bf = tp.to_tensor([1.5], dtype="bfloat16")
    assert bf.numpy().dtype == np.float32 and bf.numpy()[0] == 1.5
    p = tp.Parameter(torch.zeros(2))
    assert not p.stop_gradient and p.trainable and p.persistable
    assert p.optimize_attr == {"learning_rate": 1.0}
    assert tp.is_tensor(x) and not tp.is_tensor(np.ones(1))
    assert tp.allclose(x, x + 1e-9) is True
    assert tp.mm is tp.matmul
    # (the JAX package's top-level equal_all raises TypeError on this jax)
    assert tp.equal_all(x, x).item() is True
    assert tp.equal_all(x, x[0]).item() is False


# ------------------------------------------------------------ autograd

def _both(fn):
    """fn(P, x) on each package with x = a leaf that needs grad."""
    a = np.array([[0.5, -1.0, 2.0], [1.5, 0.3, -0.7]], np.float32)
    out = []
    for P in (tp, jp):
        x = P.to_tensor(a, stop_gradient=False)
        out.append((fn(P, x), x))
    return out


def test_backward_accumulates_as_jax():
    def fn(P, x):
        (x * x).sum().backward()
        (P.exp(x) * 2).mean().backward()
        return x.grad

    (g, _), (jg, _) = _both(fn)
    _same(g, jg)


def test_grad_with_create_graph_gives_a_second_derivative():
    def fn(P, x):
        y = (x * x * x).sum()
        (g,) = P.grad(y, x, create_graph=True)
        assert not g.stop_gradient
        (h,) = P.grad(g.sum(), x)
        return h

    (h, _), (jh, _) = _both(fn)
    _same(h, jh)
    np.testing.assert_allclose(h.numpy(), 6 * np.array(
        [[0.5, -1.0, 2.0], [1.5, 0.3, -0.7]], np.float32), rtol=1e-6)


def test_grad_of_an_unused_input():
    for P in (tp, jp):
        x = P.to_tensor([1.0], stop_gradient=False)
        z = P.to_tensor([2.0], stop_gradient=False)
        with pytest.raises(RuntimeError, match="allow_unused"):
            P.grad((x * 2).sum(), [x, z])
        gx, gz = P.grad((x * 2).sum(), [x, z], allow_unused=True)
        assert gz is None and gx.numpy().tolist() == [2.0]
        assert x.grad is None          # grad() does not accumulate


def test_grad_modes():
    x = tp.to_tensor([1.0], stop_gradient=False)
    with tp.no_grad():
        assert not tp.is_grad_enabled()
        y = x * 2
        with tp.enable_grad():
            assert tp.is_grad_enabled()
    assert y.stop_gradient and tp.is_grad_enabled()

    @tp.no_grad()
    def f(v):
        return v * 3

    assert f(x).stop_gradient
    tp.set_grad_enabled(False)
    try:
        assert (x * 2).stop_gradient and not tp.is_grad_enabled()
    finally:
        tp.set_grad_enabled(True)
    assert not (x * 2).stop_gradient


def test_hooks_retain_graph_and_clear_grad():
    def fn(P, x):
        seen = []
        y = x * 3

        def hook(g):
            seen.append(g.numpy().copy())
            return g * 2

        handle = y.register_hook(hook)
        loss = P.exp(y).sum()        # one use of y: one call in both
        loss.backward(retain_graph=True)
        first = x.grad.numpy().copy()
        handle.remove()
        loss.backward()
        assert len(seen) == 1
        return first, x.grad.numpy().copy()

    ((a1, a2), x), ((b1, b2), _) = _both(fn)
    np.testing.assert_allclose(a1, b1, rtol=1e-6)
    np.testing.assert_allclose(a2, b2, rtol=1e-6)
    x.clear_gradient(set_to_zero=True)
    assert x.grad.numpy().tolist() == [[0.0] * 3] * 2
    x.clear_grad()
    assert x.grad is None and x.gradient() is None
    y = (x * 2).sum()
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()                 # the graph is freed


def test_stop_gradient_rules():
    x = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    assert x._value.requires_grad
    y = x * 2
    assert not y.stop_gradient and not y.is_leaf and y.grad is None
    y.stop_gradient = True           # cut off for later ops
    z = (y * x).sum()
    z.backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 4.0])
    x.stop_gradient = True
    assert not x._value.requires_grad and (x * 2).stop_gradient
    i = tp.to_tensor([1, 2])
    i.stop_gradient = False          # allowed, as in JAX; no grad flows
    assert not i.stop_gradient and (i * 2).stop_gradient
    assert tp._C_ops.isnan(tp.to_tensor([1.0], stop_gradient=False)) \
        .stop_gradient               # a non-differentiable op


def test_in_place_rules_follow_jax():
    for P in (tp, jp):
        x = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
        y = x * 2
        with pytest.raises(RuntimeError, match="in-place update"):
            y[0] = 5.0
        with pytest.raises(RuntimeError, match="in-place update"):
            y.add_(x)
        with P.no_grad():
            y[0] = 5.0               # allowed without grad
        (x * x).sum().backward()
        x[1] = 10.0                  # a leaf that needs grad: replaced
        assert x.numpy().tolist() == [1.0, 10.0, 3.0]
        assert not x.stop_gradient
        (x * 1.0).sum().backward()
        assert x.grad.numpy().tolist() == [3.0, 5.0, 7.0]
        x.scale_(2.0)
        assert x.numpy().tolist() == [2.0, 20.0, 6.0]
    t = tp.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    t.reshape_([4])
    assert t.shape == [4]
    t.zero_()
    t.fill_(2.0)
    t.copy_(np.array([1, 2, 3, 4]))
    t.set_value(t * 2)
    assert t.tolist() == [2.0, 4.0, 6.0, 8.0] and _name(t.dtype) == "float32"
    u = tp.to_tensor([[1, 2], [3, 4]])
    u[:, 1] = tp.to_tensor([7, 8])
    u[0] = 9
    assert u.tolist() == [[9, 9], [3, 8]]


def test_check_nan_inf_flag():
    x = tp.to_tensor([-1.0, 1.0])
    assert np.isnan(tp.log(x).numpy()[0])
    tp.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="op log"):
            tp.log(x)
        tp.exp(x)
    finally:
        tp.set_flags({"FLAGS_check_nan_inf": False})


def test_hooks_see_every_dispatch():
    from paddle_tpu_torch.ops import registry

    seen, outs = [], []
    registry.TRACE_HOOK[0] = lambda n, a, k: seen.append(n)
    registry.CHECK_HOOK[0] = lambda n, o: outs.append((n, len(o)))
    try:
        x = tp.to_tensor([1.0, 2.0])
        (x + 1)[0].exp()
    finally:
        registry.TRACE_HOOK[0] = registry.CHECK_HOOK[0] = None
    assert seen == ["add", "_getitem", "exp"]
    assert outs == [("add", 1), ("_getitem", 1), ("exp", 1)]


# ------------------------------------------------------------ SelectedRows

def test_selected_rows_follow_jax():
    from paddle_tpu.core import selected_rows as jsr
    from paddle_tpu_torch.core import selected_rows as sr

    rng = np.random.default_rng(4)
    rows = np.array([3, 1, 3, 0])
    vals = rng.standard_normal((4, 2)).astype(np.float32)
    ours, ref = sr.SelectedRows(rows, vals, 5), jsr.SelectedRows(rows, vals,
                                                                  5)
    assert ours.shape == ref.shape == [5, 2]
    _same(sr.get_tensor_from_selected_rows(ours),
          jsr.get_tensor_from_selected_rows(ref))
    m, jm = sr.merge_selected_rows(ours), jsr.merge_selected_rows(ref)
    assert m.rows.tolist() == np.asarray(jm.rows).tolist()
    np.testing.assert_allclose(m.value.numpy(), np.asarray(jm.value),
                               rtol=1e-6)
    ids = np.array([[1, 4], [1, 2]])
    og = rng.standard_normal((2, 2, 3)).astype(np.float32)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    g = sr.embedding_sparse_grad(tp.to_tensor(w), ids, og)
    jg = jsr.embedding_sparse_grad(jp.to_tensor(w), ids, og)
    assert g.rows.tolist() == np.asarray(jg.rows).tolist()
    np.testing.assert_allclose(g.value.numpy(), np.asarray(jg.value),
                               rtol=1e-6)
    p, jpar = tp.to_tensor(w), jp.to_tensor(w)
    sr.apply_rows_sgd(p, g, 0.1)
    jsr.apply_rows_sgd(jpar, jg, 0.1)
    _same(p, jpar)
    zeros = np.zeros((6, 3), np.float32)
    m1, v1 = sr.apply_rows_adam(p, g, torch.zeros(6, 3), torch.zeros(6, 3),
                                0.01, step=2)
    jm1, jv1 = jsr.apply_rows_adam(jpar, jg, jax.numpy.asarray(zeros),
                                   jax.numpy.asarray(zeros), 0.01, step=2)
    _same(p, jpar)
    np.testing.assert_allclose(m1.numpy(), np.asarray(jm1), rtol=1e-6)
    np.testing.assert_allclose(v1.numpy(), np.asarray(jv1), rtol=1e-6,
                               atol=1e-9)


# ------------------------------------------------------------ RNG state

def test_generator_keys_equal_jax_and_state_round_trips():
    from paddle_tpu.core import random as jrandom
    from paddle_tpu_torch.core import random as trandom

    g, jg = trandom.Generator(5), jrandom.Generator(5)
    for _ in range(3):
        assert g.next_key().tolist() == np.asarray(
            jax.random.key_data(jg.next_key())).tolist()
    tp.seed(9)
    state = tp.get_rng_state()
    assert state["seed"] == 9 and state["offset"] == 0
    first = [tp.rand([3]).numpy(), tp._C_ops.uniform([2]).numpy()]
    assert tp.get_rng_state()["offset"] == 2
    tp.set_rng_state(state)
    again = [tp.rand([3]).numpy(), tp._C_ops.uniform([2]).numpy()]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    jp.seed(9)
    jp.rand([3])
    jp._C_ops.uniform([2])
    assert jp.get_rng_state()["offset"] == tp.get_rng_state()["offset"]


def test_import_initialises_no_card():
    code = ("import paddle_tpu_torch, torch, sys; "
            "sys.exit(int(torch.cuda.is_initialized()))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert subprocess.run([sys.executable, "-c", code], cwd=root,
                          timeout=120).returncode == 0
