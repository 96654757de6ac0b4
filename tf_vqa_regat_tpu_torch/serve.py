"""`--mode serve`: HTTP answer service over a checkpoint (counterpart of
tf_vqa_regat_tpu/serve.py).

- Requests are micro-batched to a small set of fixed batch sizes
  (`--serve_batch_sizes`, default 1,8,32); each size runs once at startup,
  which builds the CUDA kernels and, on CUDA, captures the size's forward
  pass as a CUDA graph (train/graphs.py) that every later call replays, so
  the first request pays neither (JAX's pre-compiled batch sizes).
- The split's tables live on the device, at --feature_dtype, under JAX's
  capacity policy (`serve_store_mode`): replicated (data/store.py) when the
  split's tables (estimate_nbytes) fit --device_store_budget_gb, else
  sharded over the data axis (data/sharded_store.py) when one shard's
  (estimate_sharded_nbytes) fits, else refused before any upload with both
  numbers. A request ships its 14 token ids and an image index; its rows
  are gathered at `resolved_num_rois()` (36 under fixed-36). On the sharded
  store each rank takes the requested images it owns and one all-reduce
  over the data group assembles the batch (`ShardedDeviceStore.gather_images`);
  that runs before the forward graph, which takes the assembled batch as
  its static input, so no collective sits in a graph.
- Concurrent requests are coalesced for up to `--serve_max_delay_ms` into
  one forward pass at the smallest fixed size that fits.
- Under a process group (dp x tp ranks) JAX drives every device from one
  process; the port has one process per rank, so rank 0 runs the HTTP
  server and the MicroBatcher, and each engine call broadcasts (B,
  questions, images, validity) from it. Every rank then gathers the batch
  and runs the forward pass (the tp ranks take part in it), and rank 0
  answers; the other ranks wait in `InferenceEngine.follow` until rank 0's
  `stop`. At tp > 1 the forward pass runs eagerly (train/step.py::
  eager_reason). Every rank runs the whole batch, so --ref_compat_q_att's
  batch-axis softmax needs no gather here: the padded slots of a batch
  (padding tokens, image 0, no boxes, as JAX pads them) take part in it,
  and the engine stays graphed.

API (JSON over HTTP, stdlib ThreadingHTTPServer), as the JAX package's:
  GET  /healthz   -> {"status": "ok", "batch_sizes": [...], ...}
  POST /predict   {"question": str, "image_id": int}
                  -> 200 {"answer": str, "confidence": float} (sigmoid prob)
                  -> 404 {"error": ...} for an unknown image_id
  POST /predict   [{...}, {...}]  -> 200 [{...}, {...}]       (client batch;
                  per-item failures appear as {"error": ...} entries)
  Malformed input -> 400; engine failure / shutdown race -> 500.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.dictionary import encode_question
from tf_vqa_regat_tpu_torch.data.features import VQADataset
from tf_vqa_regat_tpu_torch.data.sharded_store import (
    ShardedDeviceStore,
    estimate_sharded_nbytes,
)
from tf_vqa_regat_tpu_torch.data.store import (
    ImageStore,
    estimate_nbytes,
    gather_adj,
    gather_image_features,
)
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.parallel import distributed
from tf_vqa_regat_tpu_torch.parallel.mesh import Mesh, make_mesh
from tf_vqa_regat_tpu_torch.train.graphs import StepGraphs
from tf_vqa_regat_tpu_torch.train.step import resolve_graphed

# Largest client batch one POST may carry (see do_POST).
MAX_CLIENT_BATCH = 512


def serve_store_mode(cfg: Config, ds: VQADataset, include_adj: bool, dp: int = 1) -> str:
    """JAX's capacity policy (serve.py:80-140): "replicated" when the
    split's tables (estimate_nbytes) fit --device_store_budget_gb, else
    "sharded" when one of dp shards' (estimate_sharded_nbytes, with the
    semantic labels only: spatial labels are built from the boxes) fits,
    else a refusal naming both numbers and the remedy."""
    need = estimate_nbytes(ds, include_adj, cfg.feature_dtype)
    budget = int(cfg.device_store_budget_gb * 1e9)
    if need <= budget:
        return "replicated"
    sharded_adj = cfg.relation_type == "semantic"
    need_sharded = estimate_sharded_nbytes(ds, sharded_adj, cfg.feature_dtype, dp)
    if need_sharded <= budget:
        return "sharded"
    if cfg.feature_dtype != "int8":
        remedy = (f"Use --feature_dtype int8 (replicated "
                  f"~{estimate_nbytes(ds, include_adj, 'int8') / 1e9:.2f} GB, sharded "
                  f"~{estimate_sharded_nbytes(ds, sharded_adj, 'int8', dp) / 1e9:.2f} GB/shard), "
                  f"raise --device_store_budget_gb,")
    else:  # already the smallest dtype: only the budget helps
        remedy = "Raise --device_store_budget_gb"
    raise ValueError(
        f"serve: split {ds.name!r} at --feature_dtype {cfg.feature_dtype} needs "
        f"~{need / 1e9:.2f} GB replicated and ~{need_sharded / 1e9:.2f} GB/shard sharded "
        f"over dp={dp}, but the device budget is {cfg.device_store_budget_gb:.2f} GB "
        f"(--device_store_budget_gb). {remedy} serve on more chips, or serve a smaller "
        f"split."
    )


@torch.inference_mode()
def answer_logits(model: ReGAT, store: ImageStore, num_rois: int, question, img,
                  valid) -> torch.Tensor:
    """The eval forward pass of `model` on the rows of `store` at images
    `img` (InferenceEngine.logits)."""
    n_box = torch.where(valid, torch.clamp(store.img_len[img], max=num_rois),
                        torch.zeros_like(img))
    features, norm_bb, bb = gather_image_features(store, img, n_box, num_rois)
    batch = {"features": features, "norm_bb": norm_bb, "bb": bb, "question": question,
             "num_boxes": n_box}
    if store.adj is not None:
        batch["adj_label"] = gather_adj(store.adj, img, num_rois, valid)
    return model(batch)


def _answer_step(model: ReGAT, store: Optional[ImageStore], num_rois: int):
    """The engine's step for StepGraphs: (argmax label [B], its sigmoid
    confidence [B]), from the request on the replicated store, or from the
    assembled batch (`store` None: the sharded store's gather ran before)."""

    @torch.inference_mode()
    def step(B, inputs, generators) -> Tuple[torch.Tensor, torch.Tensor]:
        if store is None:
            logits = model(inputs)
        else:
            logits = answer_logits(model, store, num_rois, inputs["question"],
                                   inputs["img"], inputs["valid"])
        best = torch.argmax(logits, dim=-1)
        return best, torch.sigmoid(torch.gather(logits, 1, best[:, None])[:, 0])

    return step


class InferenceEngine:
    """Fixed-batch-size inference over device-resident features: the eval
    forward pass, then (argmax label, sigmoid confidence) per example, over
    the store serve_store_mode chooses. Under a process group every rank
    builds it alike (module docstring)."""

    def __init__(
        self,
        cfg: Config,
        ds: VQADataset,
        model: ReGAT,
        device: torch.device,
        batch_sizes: Tuple[int, ...] = (1, 8, 32),
        graphed: Optional[bool] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.ds = ds
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.dp_size, cfg.tp_size)
        include_adj = cfg.relation_type != "implicit"
        self.store_mode = serve_store_mode(cfg, ds, include_adj, self.mesh.dp)
        self.model = model.to(self.device).eval()
        self.num_rois = cfg.resolved_num_rois()
        if self.store_mode == "sharded":
            self.store = ShardedDeviceStore(
                ds, self.device, self.mesh.data, self.mesh.dp, targets=False,
                feature_dtype=cfg.feature_dtype, include_adj=cfg.relation_type == "semantic",
                cache_dir=cfg.packed_cache)
            self.meta = self.store.image_meta_arrays()
            step_store = None
        else:
            self.store = ImageStore(ds, self.device, cfg.feature_dtype,
                                    include_adj=include_adj, cache_dir=cfg.packed_cache)
            self.meta = None
            step_store = self.store
        self.img_index = {
            int(i): int(x)
            for i, x in zip(ds.entries.image_ids, ds.entries.image_index)
        }
        self.max_q_len = ds.entries.q_tokens.shape[1]
        self.batch_sizes = tuple(sorted(set(batch_sizes)))
        # one graph per batch size; a replay's outputs live until the next,
        # so a call reads them under the lock
        self.graphs = StepGraphs(_answer_step(self.model, step_store, self.num_rois),
                                 self.device, resolve_graphed(self.mesh, graphed))
        self._lock = threading.Lock()
        # every rank warms every size alike: builds the kernels, captures
        for B in self.batch_sizes:
            self._run(
                torch.zeros((B, self.max_q_len), dtype=torch.int64, device=self.device),
                torch.zeros((B,), dtype=torch.int64, device=self.device),
                torch.zeros((B,), dtype=torch.bool, device=self.device),
            )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _inputs(self, question, img, valid) -> Dict[str, torch.Tensor]:
        """The forward graph's inputs: the request on the replicated store;
        the batch assembled over the data group on the sharded store."""
        if self.meta is None:
            return {"question": question, "img": img, "valid": valid}
        n_box = torch.where(valid, torch.clamp(self.meta["img_len"][img], max=self.num_rois),
                            torch.zeros_like(img))
        features, norm_bb, bb, adj = self.store.gather_images(
            self.meta, img, n_box, self.num_rois, self.mesh.data_group())
        batch = {"features": features, "norm_bb": norm_bb, "bb": bb, "question": question,
                 "num_boxes": n_box}
        if adj is not None:
            batch["adj_label"] = adj
        return batch

    def logits(self, question, img, valid) -> torch.Tensor:
        """[B, num_answers] for token ids [B, T], image indices [B] and
        validity [B]; invalid (padded) slots get zero boxes and no edges."""
        if self.meta is None:
            return answer_logits(self.model, self.store, self.num_rois, question, img, valid)
        with torch.inference_mode():
            return self.model(self._inputs(question, img, valid))

    def _run(self, question, img, valid) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.graphs(question.shape[0], self._inputs(question, img, valid))

    def step(self, question, img, valid) -> Tuple[np.ndarray, np.ndarray]:
        """(argmax label [B], sigmoid confidence of that label [B]) on the
        host, for token ids [B, T], image indices [B] and validity [B]; on
        rank 0 of a process group, broadcast to every rank first."""
        with self._lock:
            if distributed.world_size() > 1:
                B = question.shape[0]
                distributed.broadcast_([torch.tensor([B, 0], dtype=torch.int64,
                                                     device=self.device)])
                distributed.broadcast_([question.to(torch.int64), img.to(torch.int64),
                                        valid.to(torch.int64)])
            best, conf = self._run(question, img, valid)
            return best.cpu().numpy(), conf.cpu().numpy()

    def follow(self) -> None:
        """A rank other than 0: run each call rank 0 broadcasts, until its
        `stop`."""
        while True:
            head = torch.zeros(2, dtype=torch.int64, device=self.device)
            distributed.broadcast_([head])
            B, stop = (int(x) for x in head.tolist())
            if stop:
                return
            question = torch.zeros((B, self.max_q_len), dtype=torch.int64, device=self.device)
            img = torch.zeros((B,), dtype=torch.int64, device=self.device)
            valid = torch.zeros((B,), dtype=torch.int64, device=self.device)
            distributed.broadcast_([question, img, valid])
            self._run(question, img, valid.bool())

    def stop(self) -> None:
        """Rank 0: end the other ranks' `follow` (a no-op without them)."""
        if distributed.world_size() > 1 and distributed.is_primary():
            with self._lock:
                distributed.broadcast_([torch.tensor([0, 1], dtype=torch.int64,
                                                     device=self.device)])

    def _encode(self, text: str) -> List[int]:
        """Tokenize against the model's vocabulary: ids past it map to the
        OOV row (ntoken - 1), as the JAX engine does."""
        d = self.ds.dictionary
        snap = self.ds.ntoken
        toks = encode_question(d, text, self.max_q_len)
        return [
            self.ds.padding_idx
            if t == d.padding_idx
            else (t if t < snap else snap - 1)
            for t in toks
        ]

    def infer(self, questions: List[str], image_ids: List[int]) -> List[Dict[str, Any]]:
        """Tokenize, pad to the smallest fixed batch size, run, decode."""
        n = len(questions)
        out: List[Dict[str, Any]] = []
        lo = 0
        while lo < n:
            left = n - lo
            B = next((b for b in self.batch_sizes if b >= left), self.batch_sizes[-1])
            chunk_q = questions[lo : lo + B]
            chunk_i = image_ids[lo : lo + B]
            m = len(chunk_q)
            lo += m
            toks = np.full((B, self.max_q_len), self.ds.padding_idx, np.int64)
            img = np.zeros((B,), np.int64)
            valid = np.zeros((B,), bool)
            errs: List[Optional[str]] = [None] * m
            for j, (text, iid) in enumerate(zip(chunk_q, chunk_i)):
                idx = self.img_index.get(int(iid))
                if idx is None:
                    errs[j] = f"unknown image_id {iid}"
                    continue
                toks[j] = self._encode(text)
                img[j] = idx
                valid[j] = True
            best, conf = self.step(
                torch.from_numpy(toks).to(self.device),
                torch.from_numpy(img).to(self.device),
                torch.from_numpy(valid).to(self.device),
            )
            for j in range(m):
                if errs[j] is not None:
                    out.append({"error": errs[j]})
                else:
                    out.append(
                        {
                            "answer": self.ds.label2ans[int(best[j])],
                            "confidence": float(conf[j]),
                        }
                    )
        return out


class MicroBatcher:
    """Coalesce concurrent requests into one forward pass.

    Requests queue; a worker drains up to the largest fixed batch size,
    waiting at most `max_delay_ms` for stragglers once the first request of
    a batch arrives. Callers get a Future resolved with their single result.
    """

    def __init__(self, engine: InferenceEngine, max_delay_ms: float = 5.0):
        self.engine = engine
        self.max_delay = max_delay_ms / 1000.0
        self.max_batch = max(engine.batch_sizes)
        self._q: "queue.Queue" = queue.Queue()
        self._stop = False
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, question: str, image_id: int) -> Future:
        fut: Future = Future()
        # (check _stop, enqueue) is atomic against close()'s (set _stop,
        # enqueue sentinel): a request that wins the lock is served before
        # the sentinel; one that loses fails fast.
        with self._submit_lock:
            if self._stop:
                fut.set_exception(RuntimeError("server is shutting down"))
                return fut
            self._q.put((question, image_id, fut))
        return fut

    def close(self):
        with self._submit_lock:
            self._stop = True
            self._q.put(None)
        self._worker.join(timeout=5)

    def _run(self):
        # Drain up to the sentinel: requests enqueued before it are served.
        sentinel = False
        while not sentinel:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self.max_delay
            while len(batch) < self.max_batch:
                budget = deadline - time.monotonic()
                if budget <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=budget)
                except queue.Empty:
                    break
                if nxt is None:
                    sentinel = True  # serve the batch in hand, then exit
                    break
                batch.append(nxt)
            try:
                results = self.engine.infer([b[0] for b in batch], [b[1] for b in batch])
                for (_, _, fut), res in zip(batch, results):
                    fut.set_result(res)
            except Exception as e:  # surfaced to every caller of the batch
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)


def make_engine(cfg: Config, ds: VQADataset, model: ReGAT,
                device: torch.device) -> InferenceEngine:
    """The engine at --serve_batch_sizes, as `--mode serve` builds it on
    every rank."""
    return InferenceEngine(
        cfg, ds, model, device,
        batch_sizes=tuple(int(x) for x in cfg.serve_batch_sizes.split(",") if x.strip()),
    )


def make_server(
    cfg: Config, ds: VQADataset, model: ReGAT, device: torch.device,
    port: int = 0,
) -> Tuple[ThreadingHTTPServer, MicroBatcher]:
    """Build (not start) the HTTP server; port 0 = ephemeral."""
    engine = make_engine(cfg, ds, model, device)
    batcher = MicroBatcher(engine, cfg.serve_max_delay_ms)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(
                    200,
                    {
                        "status": "ok",
                        "model": f"{cfg.relation_type}-{cfg.fusion}",
                        "split": ds.name,
                        "store": engine.store_mode,
                        "device": str(engine.device),
                        "batch_sizes": list(engine.batch_sizes),
                        "num_answers": ds.num_ans,
                    },
                )
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                return self._json(404, {"error": "not found"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
            except (ValueError, UnicodeDecodeError):
                return self._json(400, {"error": "invalid JSON"})
            if not isinstance(req, (dict, list)):
                return self._json(400, {"error": "expected a JSON object or array"})
            single = isinstance(req, dict)
            items = [req] if single else req
            # One huge request would starve concurrent ones past the 60 s
            # Future timeout; the cap keeps it to ~16 chunks.
            if not single and len(items) > MAX_CLIENT_BATCH:
                return self._json(
                    400,
                    {
                        "error": f"batch too large ({len(items)} items; "
                        f"max {MAX_CLIENT_BATCH}) — split the request"
                    },
                )
            # Validate the whole request before the first submit.
            try:
                parsed = [(str(it["question"]), int(it["image_id"])) for it in items]
            except (KeyError, TypeError, ValueError):
                return self._json(400, {"error": "each item needs question + image_id"})
            futs = [batcher.submit(q, i) for q, i in parsed]
            try:
                results = [f.result(timeout=60) for f in futs]
            except Exception as e:  # engine failure / batcher shutdown
                return self._json(500, {"error": f"inference failed: {e}"})
            if single:
                code = 404 if "error" in results[0] else 200
                return self._json(code, results[0])
            self._json(200, results)

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    return server, batcher
