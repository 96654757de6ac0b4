"""ReGAT in plain PyTorch: the benchmark's reference for one train step, an
eval forward pass and a served answer.

It follows Li et al., "Relation-Aware Graph Attention Network for Visual
Question Answering" (ICCV 2019, arXiv:1903.12314) and the configs of
linjieli222/VQA_ReGAT: a GRU question encoder with self-attention, an
implicit (fully connected, with a geometry bias) or spatial (11 edge labels
built from the boxes) relation encoder of two directions, the fusion and
classifier that the configuration's "fusion" names (each in a file of its
own under reference/fusion/), sigmoid BCE over 3,129 answers, Adamax with
a per-tensor gradient clip. It imports torch alone: no kernel, no graph,
no batching trick, and nothing of the measured program.

Parameters are a dict name -> tensor under the names of the published
TF/JAX parameter tree ("v_relation.gatt.neighbor.0.query.layers.0.v", ...),
kernels laid out [in, out]; every dense layer is weight-normed with one
scalar `g` over the whole kernel: W = g * v / ||v||.

Conventions a run must share with the program, stated here because they are
part of what a step computes:
- Dropout draws one uint8 per element from the step's generator and keeps
  the element where the draw is >= t = round(256 * rate), scaling by
  256 / (256 - t). The generator of step s is seeded with
  `step_seed(seed + 1, s)` and the masks are drawn in forward order (see
  `forward`).
- The sinusoid of the geometry embedding takes, per lane, the argument
  pos * f, with the single f32 frequency f = 100 * 1000^(-8j/P).
- The relation attention's softmax over a row's keys is taken against the
  row's max over all heads, with 1e-30 added to each head's denominator,
  as the system defines it (the JAX package's kernels, _kernel_v3 and
  _fwd_kernel_v2): a head whose logits all lie ~90 or more below another
  head's max gets all-zero weights, where a per-head softmax would spread
  them. After five or so steps at the configured rate whole heads do (tens
  of thousands of query rows' heads a batch, on some seeds), and a
  per-head softmax then parts from the system's loss by up to 7.5%. The
  system's backward passes (_fused_v3_bwd, _fused_bwd) hold that max
  constant: the gradient through it, which the 1e-30 makes nonzero for a
  head near underflow, is left out here too.
- The geometry weights pwr = relu(pe . W + b) are summed in float64 and
  rounded once to f32 before log(max(pwr, 1e-6)): near that floor one f32
  rounding step of the sum moves the log by up to ~1e-2.

`precision`: "f32" computes every product in float32 with TF32 off (the
configuration's precision); "tf32" rounds the operands of every matrix
product to TF32 (10 mantissa bits), the control that has to fail the
comparison. On a CUDA device "tf32" turns on the card's TF32 matmuls;
off the card the forward products' operands are rounded by hand (the
backward products stay f32 there).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from . import fusion

NEG_INF = -9e15
WARMUP_FACTORS = (1.0, 1.0, 1.2, 1.3, 1.4)
DECAY_START_EPOCH = 5
ADAMAX_B1, ADAMAX_B2, ADAMAX_EPS = 0.9, 0.999, 1e-8

Params = Dict[str, torch.Tensor]


# ----------------------------------------------------------------- precision

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (f32 with 10 explicit mantissa bits), to nearest
    even, kept as f32."""
    i = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    i = (i + 0xFFF + ((i >> 13) & 1)) & 0xFFFFE000
    i = torch.where(i >= 2**31, i - 2**32, i)
    return i.to(torch.int32).view(torch.float32)


class Numerics:
    """Where every matrix product of the reference goes: plain f32, or with
    its operands rounded to TF32 (`precision` "tf32", by hand off the card)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"precision {precision!r} is not f32 or tf32")
        self.precision = precision
        self.by_hand = False

    @contextlib.contextmanager
    def active(self, device: torch.device) -> Iterator[None]:
        """TF32 matmuls on (tf32 on a card) or off for the block."""
        cuda = torch.device(device).type == "cuda"
        self.by_hand = self.precision == "tf32" and not cuda
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.precision == "tf32" and cuda
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        """The operand rounded to TF32 by hand in the forward pass; the
        gradient passes through unrounded."""
        return x + (round_tf32(x.detach()) - x).detach() if self.by_hand else x

    def ein(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self._round(o) for o in ops))

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self._round(x), self._round(w))


# ------------------------------------------------------------------- dropout

RANK_STRIDE = 1 << 16


def step_seed(base_seed: int, step: int, rank: int = 0) -> int:
    """The 64-bit seed of the dropout generator of data-parallel rank
    `rank` at step `step` (one microbatch): base_seed and step plus
    rank * 2**16 times the golden ratio's 2**32 multiple, modulo 2**32,
    in the upper and lower halves."""
    mix = rank * RANK_STRIDE * 0x9E3779B9
    return (((base_seed + mix) & 0xFFFFFFFF) << 32) | ((step + mix) & 0xFFFFFFFF)


def drop(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """8-bit inverted dropout (module docstring); identity without a
    generator (eval) or at rate 0."""
    if gen is None or rate <= 0.0:
        return x
    return x * keep_scale(x.shape, rate, gen, x.device)


def keep_scale(shape, rate: float, gen: torch.Generator, device) -> torch.Tensor:
    """The kept elements' scale, 0 where dropped, f32 [shape]."""
    t = min(255, max(1, int(round(rate * 256.0))))
    bits = torch.randint(0, 256, tuple(shape), generator=gen, dtype=torch.uint8, device=device)
    return torch.where(bits >= t, 256.0 / (256 - t), 0.0).to(torch.float32)


# -------------------------------------------------------------------- layers

class Model:
    """The forward pass and loss over `params` for a configuration dict
    `cfg` (the keys of regat_bench/configs/*.json)."""

    def __init__(self, cfg: dict, params: Params, numerics: Optional[Numerics] = None):
        self.cfg, self.p = cfg, params
        self.nx = numerics or Numerics()
        self.drop = float(cfg["dropout"])
        self.graph_drop = 0.2 if self.drop > 0 else 0.0
        self.fusion = fusion.load(cfg["fusion"])

    def wn(self, name: str) -> torch.Tensor:
        v, g = self.p[name + ".v"], self.p[name + ".g"]
        return v * (g / torch.sqrt(torch.sum(v * v) + 1e-12))

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = self.nx.mm(x, self.wn(name))
        b = self.p.get(name + ".b")
        return y if b is None else y + b

    # language
    def embed(self, q: torch.Tensor, gen) -> torch.Tensor:
        pad = int(self.cfg["ntoken"])
        keep = (q != pad)[..., None]
        e = torch.cat([self.p["w_emb.emb.table"][q], self.p["w_emb.emb_.table"][q]], dim=-1)
        return drop(torch.where(keep, e, 0.0), self.drop, gen)

    def gru(self, x: torch.Tensor) -> torch.Tensor:
        """Keras GRU, reset_after, gates z, r, h; h0 = 0 -> [b, T, h]."""
        W, U, bias = (self.p["q_emb.gru." + k] for k in ("kernel", "recurrent_kernel", "bias"))
        b, T, _ = x.shape
        xs = self.nx.mm(x, W) + bias[0]
        h = torch.zeros(b, U.shape[0], dtype=x.dtype, device=x.device)
        out = []
        for t in range(T):
            hs = self.nx.mm(h, U) + bias[1]
            xz, xr, xh = xs[:, t].chunk(3, dim=-1)
            hz, hr, hh = hs.chunk(3, dim=-1)
            z = torch.sigmoid(xz + hz)
            r = torch.sigmoid(xr + hr)
            h = z * h + (1 - z) * torch.tanh(xh + r * hh)
            out.append(h)
        return torch.stack(out, dim=1)

    def question_attention(self, seq: torch.Tensor, gen) -> torch.Tensor:
        a = torch.tanh(self.dense("q_att.linear1.layers.0", drop(seq, self.drop, gen)))
        logits = self.dense("q_att.linear2.layers.0", a)[..., 0]
        w = torch.softmax(logits, dim=-1)
        return drop(self.nx.ein("bt,bth->bh", w, seq), self.drop, gen)

    # relations
    def attention(self, d: int, roi: torch.Tensor, key_mask: torch.Tensor, gen,
                  geometry: Optional[torch.Tensor] = None,
                  edge_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One direction over keys 0..n-1: [b, R, D] -> [b, R, D]. The bias
        is the geometry term (implicit) or the edge-label term (explicit)."""
        pre = f"v_relation.gatt.neighbor.{d}."
        b, R, D = roi.shape
        n = key_mask.shape[1]
        H = int(self.cfg["num_heads"])
        dh = D // H
        rate = self.graph_drop
        q = self.dense(pre + "query.layers.0", drop(roi, rate, gen)).view(b, R, H, dh)
        trunc = roi[:, :n]
        k = self.dense(pre + "key.layers.0", drop(trunc, rate, gen)).view(b, n, H, dh)
        vw = self.nx.ein("bnd,hdo->bnho", trunc, self.wn(pre + "out"))
        mask = torch.where(key_mask, 0.0, NEG_INF)[:, None, None, :]
        if geometry is not None:
            bias = self.geometry_bias(pre + "pair_pos_fc.layers.0", geometry, gen) + mask
        else:
            bias = edge_bias[:, :, None, :] + mask
        aff = self.nx.ein("brhd,bnhd->brhn", q, k) * (1.0 / math.sqrt(dh)) + bias
        e = torch.exp(aff - aff.amax(dim=(2, 3), keepdim=True).detach())  # the row's max
        w = e / (e.sum(dim=-1, keepdim=True) + 1e-30)
        out = self.nx.ein("brhn,bnho->brho", w, vw).reshape(b, R, D)
        return out + self.p[pre + "out.b"]

    def geometry_bias(self, fc: str, pos: torch.Tensor, gen) -> torch.Tensor:
        """log(max(relu(pe . W + b), 1e-6)) [b, R, H, n] for the position
        matrix [b, R, n, 4]; pe's keep-mask is drawn here (graph rate)."""
        P = int(self.cfg["imp_pos_emb_dim"])
        pe = sinusoid(pos, P)
        if gen is not None and self.graph_drop > 0:
            pe = pe * keep_scale(pe.shape, self.graph_drop, gen, pe.device)
        W = self.wn(fc)
        if self.nx.precision == "tf32":
            pwr = torch.relu(self.nx.ein("brnp,ph->brhn", pe, W) + self.p[fc + ".b"][:, None])
        else:  # summed in f64, rounded once (module docstring)
            pwr = torch.relu(torch.einsum("brnp,ph->brhn", pe.double(), W.double())
                             + self.p[fc + ".b"].double()[:, None]).float()
        return torch.log(torch.clamp(pwr, min=1e-6))

    def encoder_step(self, visual, q_vec, roi_mask, key_mask, gen, geometry=None,
                     onehot=None) -> torch.Tensor:
        rate = self.graph_drop
        qv = torch.where(roi_mask[..., None], q_vec[:, None, :], 0.0).expand(
            -1, visual.shape[1], -1)
        x = torch.cat([visual, qv], dim=-1)
        self_feat = self.dense("v_relation.gatt.self_weights.layers.0", drop(x, rate, gen))
        out = self_feat
        n = key_mask.shape[1]
        for d in range(int(self.cfg["dir_num"])):
            if onehot is None:
                out = out + self.attention(d, self_feat, key_mask, gen, geometry=geometry)
                continue
            adj = (onehot if d == 0 else onehot.transpose(1, 2))[:, :, :n]
            edge = adj.sum(dim=-1) > 0
            label = self.dense("v_relation.gatt.bias.layers.0",
                               drop(adj, 0.2 if rate > 0 else 0.0, gen))[..., 0]
            out = out + self.attention(d, self_feat, key_mask, gen,
                                       edge_bias=torch.where(edge, label, NEG_INF))
        return torch.relu(drop(out, rate, gen))

    # whole model
    def forward(self, batch: Dict[str, torch.Tensor], gen=None) -> torch.Tensor:
        """Answer logits [b, num_answers]. With `gen` (training) the masks
        are drawn in this order: word embedding, question self-attention's
        input, its output; v2out's input (implicit); self_weights' input;
        per direction (explicit: the edge labels) the query's input, the
        key's input (implicit: the geometry keep-mask); the relation's
        output; then the fusion's own (reference/fusion/<fusion>.py)."""
        cfg = self.cfg
        feats, bb = batch["features"], batch["bb"]
        b, R, _ = feats.shape
        roi_mask = torch.arange(R, device=feats.device)[None, :] < batch["num_boxes"][:, None]
        seq = self.gru(self.embed(batch["question"], gen))
        # read before the self-attention reads seq: autograd then sums seq's
        # gradient in one order whatever the fusion (fusion/__init__.py)
        q_fused = self.fusion.question(seq)
        q_vec = self.question_attention(seq, gen)
        n = min(int(cfg["nongt_dim"]), R)
        key_mask = roi_mask[:, :n]
        if cfg["relation_type"] == "implicit":
            visual = torch.relu(self.dense("v_relation.v2out.layers.0",
                                           drop(feats, self.graph_drop, gen)))
            geometry = position_matrix(bb, n)
            for _ in range(int(cfg["num_steps"])):
                visual = visual + self.encoder_step(visual, q_vec, roi_mask, key_mask, gen,
                                                    geometry=geometry)
        elif cfg["relation_type"] == "spatial":
            labels = spatial_graph(bb, batch["norm_bb"])
            L = int(cfg["spa_label_num"])
            onehot = (labels[..., None] == torch.arange(1, L + 1, device=bb.device)).float()
            visual = torch.relu(self.dense("v_relation.v2out.layers.0", feats))
            for _ in range(int(cfg["num_steps"])):
                visual = visual + self.encoder_step(visual, q_vec, roi_mask, key_mask, gen,
                                                    onehot=onehot)
        else:
            raise ValueError(f"relation_type {cfg['relation_type']!r} has no reference here")
        if not cfg.get("residual_connection", True):
            raise ValueError("the reference follows residual_connection = true")
        return self.fusion.logits(self, visual, q_fused, roi_mask, gen)


# ------------------------------------------------------------------ geometry

def position_matrix(bb: torch.Tensor, n: int) -> torch.Tensor:
    """[b, R, 4] boxes -> [b, R, n, 4]: query roi i against key roi j < n:
    log(max(|dcx| / w_i, 1e-3)), log(max(|dcy| / h_i, 1e-3)), log(w_i / w_j),
    log(h_i / h_j), with w = x2 - x1 + 1."""
    x1, y1, x2, y2 = bb.unbind(-1)
    w, h = x2 - x1 + 1.0, y2 - y1 + 1.0
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    dx = torch.log(torch.clamp(torch.abs(cx[:, :, None] - cx[:, None, :n]) / w[:, :, None],
                               min=1e-3))
    dy = torch.log(torch.clamp(torch.abs(cy[:, :, None] - cy[:, None, :n]) / h[:, :, None],
                               min=1e-3))
    dw = torch.log(w[:, :, None] / w[:, None, :n])
    dh = torch.log(h[:, :, None] / h[:, None, :n])
    return torch.stack([dx, dy, dw, dh], dim=-1)


def sinusoid(pos: torch.Tensor, P: int) -> torch.Tensor:
    """[..., 4] -> [..., P]: per geometry feature P/8 sines then P/8
    cosines of pos * 100 * 1000^(-8j/P), j = 0..P/8-1."""
    k = P // 8
    j = torch.arange(P, dtype=torch.float64) % (2 * k) % k
    freq = (100.0 * 1000.0 ** (-(8.0 / P) * j)).to(torch.float32).to(pos.device)
    lane = torch.arange(P, device=pos.device)
    x = pos[..., lane // (2 * k)] * freq
    return torch.where(lane % (2 * k) >= k, torch.cos(x), torch.sin(x))


def spatial_graph(bb: torch.Tensor, norm_bb: torch.Tensor) -> torch.Tensor:
    """The spatial relation label of every ordered box pair (i, j), [b, R, R]
    int64, from ReGAT's build_graph: 1 j inside i, 2 j covers i, 3 IoU >=
    0.5, 4..11 the pi/4 sector of the direction i -> j when the centres lie
    within half the image diagonal, 0 otherwise; 12 on the diagonal. The
    image size comes from box 0 and its normalised width and height. Boxes
    that are all zero (padding) have no edges. As in the published code,
    the fourth quadrant's angle is -arccos(sin) + 2 pi, and the lower
    triangle takes the reverse pair's sector."""
    R = bb.shape[1]
    x1, y1, x2, y2 = bb.unbind(-1)
    w, h = x2 - x1 + 1.0, y2 - y1 + 1.0
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    img_h = h[:, 0] / norm_bb[:, 0, 5]
    img_w = w[:, 0] / norm_bb[:, 0, 4]
    half_diag = 0.5 * torch.sqrt(img_h ** 2 + img_w ** 2)

    def pair(a):  # (a_i, a_j) broadcast to [b, R, R]
        return a[:, :, None], a[:, None, :]

    (x1i, x1j), (y1i, y1j), (x2i, x2j), (y2i, y2j) = map(pair, (x1, y1, x2, y2))
    inside = (x1i < x1j) & (x2i > x2j) & (y1i < y1j) & (y2i > y2j)
    covers = inside.transpose(1, 2)
    iw = torch.clamp(torch.minimum(x2i, x2j) - torch.maximum(x1i, x1j) + 1.0, min=0.0)
    ih = torch.clamp(torch.minimum(y2i, y2j) - torch.maximum(y1i, y1j) + 1.0, min=0.0)
    area = w * h
    inter = iw * ih
    iou = inter / torch.clamp(area[:, :, None] + area[:, None, :] - inter, min=1e-12)

    (cxi, cxj), (cyi, cyj) = pair(cx), pair(cy)
    ydiff, xdiff = cyi - cyj, cxi - cxj
    dist = torch.sqrt(ydiff ** 2 + xdiff ** 2)
    near = dist < half_diag[:, None, None]
    sin = ydiff / torch.clamp(dist, min=1e-12)
    cos = xdiff / torch.clamp(dist, min=1e-12)
    two_pi = 2.0 * math.pi
    angle = torch.where(
        sin >= 0,
        torch.where(cos >= 0, torch.asin(sin), torch.acos(cos)),
        torch.where(cos >= 0, torch.asin(sin) + two_pi,
                    two_pi - torch.acos(torch.clamp(sin, -1.0, 1.0))))
    reverse = torch.where(sin >= 0, two_pi - angle, angle - math.pi)
    sector = torch.ceil(angle / (math.pi / 4)).long() + 3
    sector_rev = torch.ceil(reverse / (math.pi / 4)).long() + 3
    idx = torch.arange(R, device=bb.device)
    sector = torch.where(idx[:, None] < idx[None, :], sector, sector_rev.transpose(1, 2))

    label = torch.where(near, sector, 0)
    label = torch.where(iou >= 0.5, 3, label)
    label = torch.where(covers, 2, label)
    label = torch.where(inside, 1, label)
    real = torch.sum(bb, dim=-1) != 0
    label = torch.where(real[:, :, None] & real[:, None, :], label, 0)
    return torch.where((idx[:, None] == idx[None, :]) & real[:, :, None], 12, label)


# ---------------------------------------------------------------- loss, step

def bce_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sigmoid BCE summed over answers, mean over the batch."""
    per = torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    return per.sum(dim=-1).mean()


def score_sum(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.gather(target, 1, logits.argmax(dim=-1)[:, None]).sum()


def frozen(cfg: dict, names: Sequence[str]) -> List[str]:
    """Leaves that take no update: the second word table (trained only after
    a TF-IDF init), the biases that feed a softmax directly, and the
    fusion's own (its FROZEN)."""
    out = ["w_emb.emb_.table", "q_att.linear2.layers.0.b"]
    out += fusion.load(cfg["fusion"]).FROZEN
    out += [n for n in names if n.startswith("v_relation.gatt.neighbor.")
            and n.endswith(".key.layers.0.b")]
    return [n for n in out if n in names]


def learning_rate(cfg: dict, step: int, steps_per_epoch: int) -> float:
    """Warm-up factors over epochs 0-4, then decay by lr_decay_rate every
    lr_decay_step epochs from epoch 5."""
    epoch = step // steps_per_epoch
    base = float(cfg["base_lr"])
    if epoch < len(WARMUP_FACTORS):
        return base * WARMUP_FACTORS[epoch]
    decays = (epoch - DECAY_START_EPOCH) // int(cfg["lr_decay_step"]) + 1
    return base * WARMUP_FACTORS[-1] * float(cfg["lr_decay_rate"]) ** decays


class Trainer:
    """Adamax (b1 0.9, b2 0.999, eps 1e-8) after a per-tensor L2 clip at
    cfg["grad_clip"], frozen leaves updated in their moments only."""

    def __init__(self, cfg: dict, params: Params, steps_per_epoch: int,
                 numerics: Optional[Numerics] = None):
        self.cfg, self.steps_per_epoch = cfg, steps_per_epoch
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.frozen = set(frozen(cfg, list(self.params)))
        self.numerics = numerics or Numerics()
        self.count = 0

    def step(self, batch: Dict[str, torch.Tensor], seed: int) -> float:
        """One step on `batch` with the dropout generator of (seed, count)
        -> the batch's loss."""
        return self.step_parts([batch], seed)

    def step_parts(self, parts: Sequence[Dict[str, torch.Tensor]], seed: int) -> float:
        """One step on the batch made of `parts`, part r the rows of
        data-parallel rank r with its own dropout generator -> the batch's
        loss (the sum over all rows over their count)."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        model = Model(self.cfg, leaves, self.numerics)
        total, count = 0.0, 0
        for rank, batch in enumerate(parts):
            if batch is None:
                continue
            gen = torch.Generator(device=batch["features"].device)
            gen.manual_seed(step_seed(seed + 1, self.count, rank))
            n = batch["features"].shape[0]
            total = total + bce_loss(model.forward(batch, gen), batch["target"]) * n
            count += n
        loss = total / count
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        clip = float(self.cfg["grad_clip"])
        lr = learning_rate(self.cfg, self.count, self.steps_per_epoch)
        self.count += 1
        corr = 1.0 - ADAMAX_B1 ** self.count
        with torch.no_grad():
            for k, g in zip(names, grads):
                g = torch.zeros_like(self.params[k]) if g is None else g
                g = g * torch.clamp(clip / torch.clamp(torch.linalg.vector_norm(g), min=1e-12),
                                    max=1.0)
                self.mu[k] = ADAMAX_B1 * self.mu[k] + (1 - ADAMAX_B1) * g
                self.nu[k] = torch.maximum(ADAMAX_B2 * self.nu[k], g.abs() + ADAMAX_EPS)
                if k not in self.frozen:
                    self.params[k] = self.params[k] - (lr / corr) * self.mu[k] / self.nu[k]
        return float(loss.detach())


def evaluate(cfg: dict, params: Params, batch: Dict[str, torch.Tensor],
             numerics: Optional[Numerics] = None) -> Tuple[torch.Tensor, float, float]:
    """(logits, mean loss, score sum) of one eval batch."""
    with torch.no_grad():
        logits = Model(cfg, params, numerics).forward(batch)
        return logits, float(bce_loss(logits, batch["target"])), float(score_sum(
            logits, batch["target"]))
