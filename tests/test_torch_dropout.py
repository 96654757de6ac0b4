"""Dropout from its uint8 draw (ops/kernels/dropout.py, nn.py::dropout) on
the CPU:

- the autograd Function's plain path equals the formulation it replaced (a
  bool keep-mask and `torch.where`, its gradient by autograd) bit for bit,
  forward and gradient, f32 and bf16, at rates 0.2 and 0.5, on a contiguous
  input, a row-strided one like the key projection's `roi[:, :n]`, a
  tensor-parallel part of the draw and an input broadcast along the rois
  (MuTAN's question drop);
- the only tensor saved for the backward is the uint8 draw;
- a train step of butd, spatial, BAN and MuTAN at small widths draws what
  the replaced formulation drew, in the same order and number (the
  generator ends in the same state), and gives the same loss and gradients
  bit for bit; the eval, no-dropout and rate >= 1 branches are unchanged;
- the kernel's rows (`launch_rows`): x and the bits as views of rows of
  contiguous elements over the fewest leading axes where their layouts
  have one (`roi[:, :n]`, the label drop's roi slice, a tensor-parallel
  part), contiguous copies otherwise, and what it refuses; the
  kernel's arguments, read as it reads them, give the plain version's bits
  at every layout; its ctypes signature is the source's declaration; the
  plain version's output and gradient are contiguous whatever x's layout,
  as the kernel's are;
- a tensor on the card goes to the kernel (counted by direction, an empty
  one neither launched nor counted), one on the CPU to the plain version,
  any other device raises;
- the "dropout" counter is registered with the launch layer and scaled by
  graph replay like B1's and B2's, while `graphs.launch_counts()` keeps its
  keys; the `[setup]` line prints it once the kernel has launched.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import sys
import types

import pytest
import torch

from regat_bench import kernels as bench_kernels
from tf_vqa_regat_tpu_torch import nn as tnn
from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.ops.kernels import dropout as kd
from tf_vqa_regat_tpu_torch.ops.kernels import launch
from tf_vqa_regat_tpu_torch.train import graphs, profiling
from tf_vqa_regat_tpu_torch.train.step import train_forward

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
V_DIM, NUM_ANS = 24, 7


@pytest.fixture(autouse=True)
def _counts():
    """Each test starts from empty counters and leaves them as it found
    them."""
    saved = launch.counts()
    launch.set_counts({})
    yield
    launch.set_counts(saved)


def parent_dropout(x, rate, train, generator=None, part=None):
    """nn.py::dropout as it was before the kernel: a bool keep-mask from the
    same draw, `torch.where`, the gradient by autograd."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    if part is None:
        keep = tnn.keep_mask(x.shape, rate, generator, x.device)
    else:
        i, n = part
        w = x.shape[-1]
        keep = tnn.keep_mask(x.shape[:-1] + (w * n,), rate, generator, x.device)[..., i * w:(i + 1) * w]
    scale = 256.0 / (256 - tnn.drop_threshold(rate))
    if x.dtype != torch.float32:
        scale = float(torch.tensor(scale, dtype=x.dtype))
    return torch.where(keep, x * scale, torch.zeros_like(x))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int32 if a.element_size() == 4 else torch.int16
    return a.shape == b.shape and torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def _input(layout: str, dtype: torch.dtype):
    """(x as a view with requires_grad, the leaf it is a view of, part)."""
    g = torch.Generator().manual_seed(3)
    if layout == "contiguous":
        leaf = torch.randn(4, 10, 24, generator=g).to(dtype).requires_grad_()
        return leaf * 1, leaf, None
    if layout == "rows":  # roi[:, :n]
        leaf = torch.randn(4, 10, 24, generator=g).to(dtype).requires_grad_()
        return leaf[:, :6], leaf, None
    if layout in ("part0", "part1"):  # a tensor-parallel rank's half of [b, 2 w]
        leaf = torch.randn(5, 12, generator=g).to(dtype).requires_grad_()
        return leaf * 1, leaf, (int(layout[-1]), 2)
    assert layout == "broadcast"  # MuTAN's question over the rois
    leaf = torch.randn(4, 1, 24, generator=g).to(dtype).requires_grad_()
    return leaf.expand(4, 10, 24), leaf, None


LAYOUTS = ["contiguous", "rows", "part0", "part1", "broadcast"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("rate", [0.2, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_path_equals_the_replaced_formulation(layout, rate, dtype):
    got, want = [], []
    for fn, out in ((tnn.dropout, got), (parent_dropout, want)):
        x, leaf, part = _input(layout, dtype)
        dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(4)).to(dtype)
        y = fn(x, rate, True, torch.Generator().manual_seed(9), part)
        out += [y, torch.autograd.grad(y, leaf, dy)[0]]
    assert got[0].grad_fn.name() == "DropoutBackward"
    assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
    # something was dropped and something kept
    assert 0 < int((got[0] == 0).sum()) < got[0].numel()


def test_the_saved_tensor_is_the_uint8_draw():
    x = torch.randn(6, 40, requires_grad=True)
    y = tnn.dropout(x, 0.2, True, torch.Generator().manual_seed(5))
    (saved,) = y.grad_fn.saved_tensors
    draw = torch.randint(0, 256, (6, 40), generator=torch.Generator().manual_seed(5),
                         dtype=torch.uint8)
    assert saved.dtype == torch.uint8 and torch.equal(saved, draw)
    # a part saves its slice of the whole draw, as the bool mask was
    y = tnn.dropout(x, 0.2, True, torch.Generator().manual_seed(5), (1, 3))
    (saved,) = y.grad_fn.saved_tensors
    whole = torch.randint(0, 256, (6, 120), generator=torch.Generator().manual_seed(5),
                          dtype=torch.uint8)
    assert torch.equal(saved, whole[:, 40:80])


def test_branches_without_a_draw_are_unchanged():
    x = torch.randn(3, 8)
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    assert tnn.dropout(x, 0.2, False, g) is x
    assert tnn.dropout(x, 0.0, True, g) is x
    assert torch.equal(tnn.dropout(x, 1.0, True, g), torch.zeros_like(x))
    assert torch.equal(g.get_state(), state)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        tnn.dropout(x, 0.2, True)


@contextlib.contextmanager
def _dropout_as(fn):
    """Every module of the port that imported nn.dropout calls `fn` instead."""
    real = tnn.dropout
    users = [m for name, m in list(sys.modules.items())
             if name.startswith("tf_vqa_regat_tpu_torch") and getattr(m, "dropout", None) is real]
    for m in users:
        m.dropout = fn
    try:
        yield
    finally:
        for m in users:
            m.dropout = real


def _cfg(**kw):
    base = dict(num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
                relation_type="implicit", fusion="butd", residual_connection=True,
                adaptive=True, num_rois=12, batch_size=8, dropout=0.2)
    base.update(kw)
    return Config(**base)


FAMILIES = {
    "butd": {},
    "spatial": dict(relation_type="spatial"),
    "ban": dict(fusion="ban", ban_glimpse=2),
    "mutan": dict(fusion="mutan", mutan_rank=3),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_train_step_draws_and_computes_what_it_did(family):
    cfg = _cfg(**FAMILIES[family])
    train = synthetic_dataset(num_images=6, num_questions=16, v_dim=V_DIM, num_ans=NUM_ANS)
    store = DeviceStore(train, CPU)
    idx = next(store.epoch_indices(0, cfg.batch_size, True, cfg.seed))
    batch = gather_batch(store, torch.from_numpy(idx), cfg.num_rois)
    model = ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
    params = list(model.parameters())
    runs = []
    for fn in (tnn.dropout, parent_dropout):
        g = torch.Generator().manual_seed(77)
        with _dropout_as(fn):
            loss, _ = train_forward(model, batch, 0, cfg.seed, generator=g)
            grads = torch.autograd.grad(loss, params)
        runs.append((loss, grads, g.get_state()))
    (loss, grads, state), (loss_p, grads_p, state_p) = runs
    assert torch.equal(state, state_p)  # the same number of draws
    assert same_bits(loss, loss_p)
    assert all(same_bits(a, b) for a, b in zip(grads, grads_p))


# ---- the kernel's rows -----------------------------------------------------------


def emulate(x_ptr: int, bits_ptr: int, out_ptr: int, rows: int, inner: int, x_row: int,
            bits_row: int, dtype: int, t: int, scale: float, live) -> None:
    """csrc/dropout.cu on its arguments: `rows` rows of `inner` elements
    addressed from each pointer through its row stride (the tensors that
    `live` resolves the pointers to), out written contiguously, the product
    in f32 rounded once to the input's dtype."""
    x, bits, out = live[x_ptr], live[bits_ptr], live[out_ptr]
    assert kd.DTYPES[x.dtype] == dtype and rows * inner == out.numel()
    xr = x.as_strided((rows, inner), (x_row, 1), x.storage_offset())
    br = bits.as_strided((rows, inner), (bits_row, 1), bits.storage_offset())
    vals = xr.float() * torch.tensor(scale, dtype=torch.float32)
    out.view(rows, inner).copy_(torch.where(br >= t, vals.to(x.dtype),
                                            torch.zeros((), dtype=x.dtype)))


def _layout(name: str, dtype: torch.dtype):
    """(x, bits, the rows the kernel takes them as, whether x and whether
    the bits are copied to contiguous tensors first)."""
    g = torch.Generator().manual_seed(8)

    def draw(*shape):
        return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(dtype)

    if name == "contiguous":  # one row
        return rand(6, 10, 32), draw(6, 10, 32), 1, False, False
    if name == "rows":  # roi[:, :n]: rows of one outer stride
        return rand(6, 10, 32)[:, :4], draw(6, 4, 32), 6, False, False
    if name == "part":  # a rank's part of the draw [b, 2 w]
        return rand(5, 24), draw(5, 48)[:, 24:], 5, False, False
    if name == "part_of_rows":  # a part of a 3-D draw: rows over the first two axes
        return rand(3, 4, 24), draw(3, 4, 48)[..., :24], 12, False, False
    if name == "label_slice":  # the label drop's [b, R, n, L] of [b, R, R, L]
        return rand(3, 7, 7, 11)[:, :, :5], draw(3, 7, 5, 11), 21, False, False
    if name == "broadcast":  # MuTAN: a stride of 0 along the rois
        return rand(4, 1, 24).expand(4, 10, 24), draw(4, 10, 24), 1, True, False
    if name == "labels":  # the label drop's transposed direction
        x = rand(3, 7, 7, 11).transpose(1, 2)[:, :, :5]
        return x, draw(3, 7, 5, 11), 1, True, False
    if name == "misaligned":  # starts one element into its storage
        return rand(65)[1:], draw(64), 1, False, False
    if name == "cotangent_of_a_sum":  # every stride 0
        return rand(1).expand(4, 6, 8), draw(4, 6, 8), 1, True, False
    assert name == "strided_vector"  # every other element
    return rand(20)[::2], draw(10), 1, True, False


LAUNCH_LAYOUTS = ["contiguous", "rows", "part", "part_of_rows", "label_slice", "broadcast",
                  "labels", "misaligned", "cotangent_of_a_sum", "strided_vector"]


@pytest.mark.parametrize("name", LAUNCH_LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_kernel_takes_every_layout_as_rows(name, dtype):
    x, bits, n, x_copied, bits_copied = _layout(name, dtype)
    xr, br = kd.launch_rows(x, bits)
    assert xr.shape == br.shape == (n, x.numel() // n)
    assert xr.stride(1) == 1 or xr.shape[1] == 1
    assert br.stride(1) == 1 or br.shape[1] == 1
    # a view where the layout has one: the kernel reads x and the bits in place
    assert (xr.data_ptr() != x.data_ptr()) == x_copied
    assert (br.data_ptr() != bits.data_ptr()) == bits_copied
    t, scale = tnn.drop_threshold(0.2), 256.0 / 205
    if dtype != torch.float32:
        scale = float(torch.tensor(scale, dtype=dtype))
    out = torch.empty(x.shape, dtype=dtype)
    live = {xr.data_ptr(): xr, br.data_ptr(): br, out.data_ptr(): out}
    emulate(xr.data_ptr(), br.data_ptr(), out.data_ptr(), *xr.shape, xr.stride(0),
            br.stride(0), kd.DTYPES[dtype], t, scale, live)
    assert same_bits(out, kd.dropout_plain(x, bits, t, scale))


@pytest.mark.parametrize("case, error", [
    ("float16", "the dropout kernel takes"),
    ("bool bits", "the kernel takes uint8"),
    ("2**31 elements", "exceed the dropout kernel's 32-bit indices"),
])
def test_the_kernel_refuses_what_it_does_not_take(case, error):
    x, bits = torch.zeros(4, 6), torch.zeros(4, 6, dtype=torch.uint8)
    if case == "float16":
        x = x.half()
    elif case == "bool bits":
        bits = bits.bool()
    else:
        x = torch.empty(2**31, device="meta")
        bits = torch.empty(2**31, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match=error):
        kd.launch_rows(x, bits)


def test_the_signature_is_the_sources():
    """The ctypes table passes what `regat_dropout` declares, in its order."""
    decl = re.search(r"int regat_dropout\(([^)]*)\)", kd.SOURCE.read_text()).group(1)
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "long long": ctypes.c_longlong, "int": ctypes.c_int, "float": ctypes.c_float,
             "cudaStream_t": ctypes.c_void_p}
    params = [" ".join(p.split()[:-1]) for p in decl.split(",")]
    argtypes, restype = kd.LIB.functions["regat_dropout"]
    assert list(argtypes) == [ctype[p] for p in params] and restype is ctypes.c_int


@pytest.mark.parametrize("layout", LAYOUTS + ["labels"])
def test_the_plain_output_and_gradient_are_contiguous(layout):
    """The plain version's output and input gradient have the layout the
    kernel's have (contiguous), whatever x's: the `where` takes it from the
    mask, so a strided site hands the layers after it what it handed them
    before the kernel."""
    if layout == "labels":
        leaf = torch.randn(3, 7, 7, 11).requires_grad_()
        x, part = leaf.transpose(1, 2), None
    else:
        x, leaf, part = _input(layout, torch.float32)
    assert (layout in ("contiguous", "part0", "part1")) == x.is_contiguous()
    y = parent_dropout(x, 0.2, True, torch.Generator().manual_seed(2), part)
    for dy in (torch.randn(x.shape), torch.randn(x.shape[::-1]).permute(
            *reversed(range(x.dim())))):
        (dx,) = torch.autograd.grad(y, x, dy, retain_graph=True)
        assert y.is_contiguous() and dx.is_contiguous()


# ---- routing and counting -------------------------------------------------------


def _fake_card(monkeypatch):
    """kd.LIB pointed at the Python model of the kernel, which resolves the
    pointers it is handed among the tensors registered in `live`; CPU
    tensors stand in for the card's."""
    live, launched = {}, []

    def regat_dropout(*args):
        launched.append(args[3])
        emulate(*args[:-1], live)
        return 0

    monkeypatch.setattr(kd.LIB, "load", lambda: types.SimpleNamespace(regat_dropout=regat_dropout))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)  # a CPU tensor's index
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda _index: 0, raising=False)
    real_empty = torch.empty

    def empty(*args, **kw):
        t = real_empty(*args, **kw)
        live[t.data_ptr()] = t
        return t

    monkeypatch.setattr(kd.torch, "empty", empty)
    return live, launched


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_kernel_launches_and_counts_by_direction(dtype, monkeypatch):
    live, launched = _fake_card(monkeypatch)
    x, bits, *_ = _layout("rows", dtype)
    dy = torch.randn(x.shape).to(dtype)
    for t in (x, bits, dy):
        live[t.data_ptr()] = t
    scale = float(torch.tensor(1.25, dtype=dtype))
    out = kd.kernel(x, bits, 51, scale, "forward")
    dx = kd.kernel(dy, bits, 51, scale, "backward")
    # x's rows are its first axis; dy and the bits are contiguous: one row
    assert launched == [6, 1] and out.is_contiguous()
    assert same_bits(out, kd.dropout_plain(x, bits, 51, scale))
    assert same_bits(dx, kd.dropout_plain(dy, bits, 51, scale))
    assert kd.COUNTS == {"forward": 1, "backward": 1}
    assert launch.counter("dropout") is kd.COUNTS
    # an empty tensor launches nothing, and counts nothing
    assert kd.kernel(x[:0], bits[:0], 51, scale, "forward").shape == x[:0].shape
    assert launched == [6, 1] and kd.COUNTS == {"forward": 1, "backward": 1}
    with pytest.raises(ValueError, match="bits is torch.bool"):
        kd.kernel(x, bits.bool(), 51, scale, "forward")


def test_routing_by_device(monkeypatch):
    calls = []
    monkeypatch.setattr(kd, "kernel", lambda *a: calls.append(a[-1]) or a[0])
    x, bits = torch.randn(3, 4), torch.randint(0, 256, (3, 4), dtype=torch.uint8)
    card = types.SimpleNamespace(device=torch.device("cuda"))
    assert kd.drop(card, bits, 51, 1.25, "backward") is card and calls == ["backward"]
    assert same_bits(kd.drop(x, bits, 51, 1.25, "forward"), kd.dropout_plain(x, bits, 51, 1.25))
    assert calls == ["backward"]  # the CPU tensor took the plain version
    with pytest.raises(ValueError, match="no dropout kernel for device meta"):
        kd.drop(x.to("meta"), bits, 51, 1.25, "forward")


class _FakeGraph:
    def register_generator_state(self, g):
        pass

    def capture_begin(self, **kw):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


class _FakeStream:
    def wait_stream(self, other):
        pass


def test_the_counter_is_scaled_by_graph_replay(monkeypatch):
    """What `_Graph` does around a capture and at each replay, with the
    card's graph and streams stood in for: a step of two dropout sites, one
    with a gradient, adds 2 forward and 1 backward launches a replay; the
    benchmark's view of B1's and B2's counters keeps its keys and counts
    nothing of dropout's."""
    # the launches write nothing: only their counts are read
    monkeypatch.setattr(kd.LIB, "load", lambda: types.SimpleNamespace(
        regat_dropout=lambda *args: 0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda _index: 0, raising=False)
    monkeypatch.setattr(kd, "drop", kd.kernel)  # the CPU tensors stand in for the card's
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(graphs, "_capture_stream", lambda device: _FakeStream())
    monkeypatch.setattr(profiling, "_SETUP", {})
    w = torch.randn(8, 16, requires_grad=True)

    def step(key, inputs, generators):
        g = generators[0]
        a = tnn.dropout(inputs["x"], 0.2, True, g)  # no gradient reaches x
        b = tnn.dropout(a @ w, 0.2, True, g)
        (dw,) = torch.autograd.grad(b.sum(), w)
        return dw

    before = graphs.launch_counts()
    inputs = {"x": torch.randn(5, 8)}
    graph = graphs._Graph(step, "key", inputs, 1, torch.device("cpu"), None, None)
    assert graphs.launch_counts() == before and kd.COUNTS == {}
    for replays in (1, 2, 3):
        graph.replay(inputs, (replays,))
        assert kd.COUNTS == {"forward": 2 * replays, "backward": replays}
        assert graphs.launch_counts() == before
    assert "dropout" in launch.COUNTERS
    assert bench_kernels.launched(graphs.launch_counts()) == 0


def test_the_setup_line_prints_the_launches_once_counted():
    assert "dropout" not in profiling.setup_line()
    kd.COUNTS.update(forward=7, backward=5)
    assert profiling.setup_line().endswith("; dropout launches: forward 7, backward 5")
    assert profiling.setup_line(ban=True).endswith("; dropout launches: forward 7, backward 5")


def test_the_kernel_escapes_the_benchmark_matchers():
    """The benchmark holds the trace's B1 and B2 records to their counters by
    name: the dropout kernel's names, as the profiler shows them, match
    neither."""
    assert re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                      kd.SOURCE.read_text()) == ["dropout_kernel"]
    for shown in ("dropout_kernel",
                  "void (anonymous namespace)::dropout_kernel<float, true>(float const*, "
                  "unsigned char const*, float*, unsigned int, unsigned int, long long, "
                  "long long, unsigned int, float)",
                  "_ZN12_GLOBAL__N_114dropout_kernelIfLb1EEEvPKT_PKhPS1_jjxxjf"):
        assert not (bench_kernels.is_b1_train(shown) or bench_kernels.is_b1_eval(shown)
                    or bench_kernels.is_b2(shown))

