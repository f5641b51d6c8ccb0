"""Inference engine: classify / prefill / decode / generate.

Counterpart of ``repro.serving.engine.Engine``: the compute payload that
the paper's "serverless functions" invoke (``core/worker.py``) and the
device half of continuous batching (``serving/batching.py``).

Mesh-aware, as the reference: constructed with a ``mesh``
(``launch.mesh.make_host_mesh``, one process per rank) every entry point
runs under ``dist.mesh_context(mesh)`` and the params are laid out by the
reference's planner (``strategy``, auto-picked with ``kind="infer"``;
``params_sharding`` is this rank's slice of every leaf and
:meth:`shard_params` cuts it):

  * "model" axis under "tp": the Megatron split (``models.attention``,
    ``models.mlp``, ``models.moe``, ``models.transformer``): each rank
    computes its heads, d_ff block, experts and vocabulary block, and the
    partial sums and split logits are combined over "model"
    (``dist.collectives``). Caches hold the rank's kv heads where the
    planner cuts them (``dist.sharding.cache_shardings``).
  * data axes: every rank takes the whole batch's inputs and computes
    only its rows (the batch cut into D equal blocks where D divides it,
    else whole on every rank, as ``input_shardings``), and every rank
    returns the whole batch's logits or tokens, gathered over the data
    axes. A shared cache holds only the rank's rows (``Cache.row_shards``):
    an admission prefills on the ranks that own its row (on every rank
    where params are cut over the data axes, whose gathers span them),
    which broadcast the logits or token to the rest; an eviction touches
    the owners' cache alone.
  * ``seq_shard=True`` forces ``attn_impl="seq_shard"``: every dense
    cache holds this rank's block of the sequence dim
    (``dist.sharding.seq_blocks``), decode attention merges the ranks'
    partials (``dist.collectives``) and the cache never gathers. The
    params stay whole over "model" there (rows may still be cut over a
    data axis).

Sampling under a data axis draws the whole batch's noise from the shared
generator on every rank and uses its rows' slice, so the streams equal
one rank's; the sampling kernel runs on the local rows. Under a
vocab-split "model" axis the LM head gathers the logits whole
(``models.transformer``), so the sampling kernel runs there too.

  * "fsdp" and "fsdp_tp" (ZeRO-3): the params are cut over the data
    axes too ("fsdp": each leaf's largest dim over every axis; "fsdp_tp":
    the "tp" split plus a second dim over the data axes), and each layer's
    leaves are gathered at the head of the layer and dropped after it
    (``dist.collectives.gathered``, under ``dist.context.param_layout``),
    so a rank holds 1 / (D x M) of the weights and at most one gathered
    layer. A rank then computes as under "tp" ("fsdp": on whole leaves,
    every kv head, so its caches keep the kv heads whole over "model").

Every family serves under these layouts: an SSM mixer runs whole on
each "model" rank (``models.ssm``), an encoder-decoder model splits its
encoder, decoder and cross-attention heads over "model" and cuts its
rows, frame embeddings and ``EncDecCache`` over the data axes (an
admission encodes its frames once, on the row's owners). Rows are cut
over every data axis taken together ("pod" and "data" of the production
mesh) or over none, where the batch's rows are not a multiple of their
ranks (``dist.sharding.rows_all_or_none``). The
reference's guards hold too: int8 KV raises under a mesh and paged
caches raise (the batcher keeps the dense cache).

Replicas on disjoint mesh slices (``router.pool.SlicePool``): each
slice's engine is :meth:`for_mesh` of a template over a sub-mesh of
``dist.sharding.slice_meshes``, with its own process groups, so its
collectives, :meth:`agree` included, span the slice's ranks alone.

The shared-batched-cache admission path (``new_cache`` -> ``prefill_into``
-> ``decode`` -> ``free_row``) serves continuous batching: one
(n_slots, max_len, ...) cache whose per-row ``lengths`` make the decode
batch ragged, so one decode call serves every slot at its own depth. The
block-paged path (``new_paged_cache`` -> ``assign_row_pages`` ->
``extend_row`` -> ``decode`` -> ``free_row``, with ``cow_copy_page`` and
``fork_row``) is its device half beside ``serving.paged.PageAllocator``.
``RunConfig(kv_dtype="int8")`` stores K/V as int8 with per-token fp32
scales in either layout. The reference donates the cache to each of these
calls; here they write the caller's cache (its KV tensors or pools, page
table and lengths) IN PLACE and return it, so no round copies it.

Shape-bucket contract, as in the reference: every entry point routes
through one cache keyed by (kind, input shape bucket), with the
reference's keys, and ``compile_count`` counts the distinct buckets seen.
PyTorch runs eagerly, so a bucket holds the function rather than a
compiled executable, but the counts read the same as the reference's
(flat across admit/evict churn) and ``warm`` flips at the same call.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist import collectives
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.kernels.decode_attention.fused_sampling import (
    fused_sample, gumbel_noise)
from repro_torch.kernels.decode_attention.quant import KV_DTYPES
from repro_torch.models.common import RunConfig
from repro_torch.models.encdec import EncDecCache
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import Cache, PagedCache
from repro_torch.serving.sampler import sample
from repro_torch.tree import tree_leaves, tree_map, tree_map_multi


def _leaf_key(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype).removeprefix("torch."))
    x = np.asarray(x)
    return (tuple(x.shape), x.dtype.name)


def _shape_key(tree) -> tuple:
    """Hashable shape/dtype bucket of an input: an array or tensor, a dict
    of them, or a decode ``Cache`` or ``PagedCache``. The cache's type, its
    leaf names (int8 layers carry scales) and a paged cache's
    ``page_size`` take part in the key, as the reference's treedef does:
    a dense and a paged cache never share a bucket, even where their leaf
    shapes coincide."""
    if isinstance(tree, EncDecCache):
        return (("EncDecCache", tree.row_shards),) + tuple(
            _leaf_key(t) for t in tree.tensors())
    if isinstance(tree, (Cache, PagedCache)):
        head = (("PagedCache", tree.page_size)
                if isinstance(tree, PagedCache)
                else ("Cache", tree.seq_shards, tree.row_shards))
        names = tuple(tuple(layer) for layer in tree.layers)
        return head + (names,) + tuple(_leaf_key(t)
                                       for t in tree.tensors())
    if isinstance(tree, dict):
        return tuple((k, _shape_key(v)) for k, v in sorted(tree.items()))
    return _leaf_key(tree)


def _cut(t: torch.Tensor, sharding, device) -> torch.Tensor:
    """This rank's slice of ``t`` on ``device``, a tensor of its own."""
    if sharding.replicated:
        return t.to(device)
    return sharding.slice(t).to(device, copy=True)


def _check_prompt(s: int, max_len: int):
    if max_len <= 0:
        raise ValueError(f"max_len must be positive, got {max_len}")
    if s > max_len:
        raise ValueError(
            f"prompt of {s} tokens exceeds the cache's capacity of "
            f"{max_len} — allocate new_cache with a larger max_len")


def _check_mesh(model: Model, mesh, seq_shard: bool, strategy: str,
                specs) -> None:
    """The layouts the port serves: a "model" axis under "tp",
    "fsdp_tp" or with ``seq_shard``, rows over the data axes, and params
    cut over the data axes ("fsdp", "fsdp_tp"), for every family; the
    rest raise (``dist.sharding.check_layout``)."""
    if strategy not in ("tp", "fsdp", "fsdp_tp"):
        raise ValueError(f"unknown strategy {strategy!r}")
    shd.check_layout(model.cfg, mesh, strategy, seq_shard, plan=specs)


def _write_row(cache, small, row: int):
    """Row 0 of the one-row cache ``small`` (an admission's prefill)
    written into row ``row`` of the shared ``cache``, in place: each
    leaf's leading positions (KV) or whole row (SSM state, an
    encoder-decoder model's cross K/V), and the row's length."""
    if isinstance(cache, EncDecCache):
        pairs = [(big, sm) for name in ("self_k", "self_v", "cross_k",
                                        "cross_v")
                 for big, sm in zip(getattr(cache, name),
                                    getattr(small, name))]
    else:
        pairs = [(big[name], t) for big, sm in zip(cache.layers,
                                                   small.layers)
                 for name, t in sm.items()]
    for big, t in pairs:
        big[row, :t.shape[1]].copy_(t[0])
    cache.lengths[row] = small.lengths[0]


def _is_spec(x) -> bool:
    return isinstance(x, shd.PartitionSpec)


@dataclasses.dataclass
class Engine:
    """Serving engine over one built model.

    Args:
      model: ``models.build(cfg)`` facade.
      run: runtime knobs; ``run.attn_impl="pallas"`` runs attention
        through the hand-written CUDA kernels on a CUDA device (CPU
        tensors take their plain versions); it is forced to
        ``"seq_shard"`` when ``seq_shard=True`` under a mesh.
        ``run.kv_dtype="int8"`` stores every cache the engine allocates as
        int8 K/V with per-token fp32 scales (decoder-only models, no
        mesh).
      device: where params, caches and activations live (``"cuda"``
        unless the caller asks for the CPU); under a mesh, this rank's.
      mesh: optional ``dist.context.Mesh`` of the running ranks; every
        entry point runs under ``dist.mesh_context(mesh)``.
      seq_shard: cut the KV cache's SEQUENCE dim over the "model" axis
        (the layout ``dist.collectives.seq_sharded_*`` consumes).
      strategy: the planner's param layout ("tp", "fsdp" or "fsdp_tp");
        default ``dist.sharding.pick_strategy(kind="infer")``, which
        takes "fsdp_tp" where the weights over the "model" axis pass half
        the card.
    """

    model: Model
    run: RunConfig = RunConfig()
    device: Any = "cuda"
    mesh: Optional[dctx.Mesh] = None
    seq_shard: bool = False
    strategy: Optional[str] = None

    def __post_init__(self):
        if self.run.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype={self.run.kv_dtype!r} not in {KV_DTYPES}")
        if self.run.kv_dtype == "int8":
            if self.mesh is not None:
                raise ValueError(
                    "kv_dtype='int8' is single-host only — the sharding "
                    "planner has no layout for the scale leaves (see "
                    "serving/README.md); use kv_dtype='bf16' under a mesh")
            if self.model.cfg.encdec:
                raise ValueError(
                    "encoder-decoder models have no int8 KV layout "
                    "(cross-attn caches stay bf16)")
        self.params_sharding = None
        if self.mesh is not None:
            specs = self.model.param_specs
            if self.strategy is None:
                self.strategy = shd.pick_strategy(specs, self.mesh,
                                                  kind="infer")
            plan = shd.param_specs_tree(specs, self.strategy, self.mesh)
            _check_mesh(self.model, self.mesh, self.seq_shard,
                        self.strategy, plan)
            if self.seq_shard:  # params whole over "model" beside the
                # sequence-sharded cache
                plan = tree_map(lambda p: shd.drop_axis(p, "model"), plan,
                                is_leaf=_is_spec)
            zero = shd.zero_axes(self.strategy, self.mesh)
            self.params_sharding = tree_map(
                lambda p: shd.rank_sharding(p, self.mesh, zero), plan,
                is_leaf=_is_spec)
            if self.seq_shard and self.run.attn_impl != "seq_shard":
                self.run = dataclasses.replace(self.run,
                                               attn_impl="seq_shard")
        # some leaf cut over the data axes ("fsdp", "fsdp_tp"): the layers
        # gather their leaves as they run
        self._gathers = self.params_sharding is not None and any(
            sh.zero for sh in tree_leaves(
                self.params_sharding, lambda x: isinstance(x, shd.Sharding)))
        self.device = torch.device(self.device)
        self._exec: Dict[Any, Any] = {}
        self.compile_count = 0

    def place_params(self, params):
        """``params`` moved onto the engine's device (under a mesh: this
        rank's shard, as :meth:`shard_params` made it)."""
        return tree_map(lambda t: t.to(self.device), params)

    # ------------------------------------------------------------------
    # Mesh plumbing
    # ------------------------------------------------------------------

    @contextmanager
    def _ctx(self):
        """The ambient-mesh context every entry point runs under, with
        the params' layout declared where leaves are cut over the data
        axes."""
        if self.mesh is None:
            yield
            return
        with dctx.mesh_context(self.mesh), dctx.param_layout(
                self.params_sharding if self._gathers else None):
            yield

    def shard_params(self, params):
        """This rank's shard of the whole ``params`` on the engine's
        device: each leaf cut by ``params_sharding`` (whole without a
        mesh), a copy that holds only the slice."""
        if self.mesh is None:
            return self.place_params(params)
        return tree_map_multi(lambda t, sh: _cut(t, sh, self.device), params,
                              self.params_sharding)

    def agree(self, seconds: float) -> float:
        """The largest of every rank's ``seconds`` (``seconds`` itself
        off a multi-rank mesh): host decisions that read a measured time,
        such as an orchestrator's speculation, then take the same branch
        on every rank, as their collectives need."""
        if self.mesh is None or int(self.mesh.devices.size) <= 1:
            return seconds
        group = self.mesh.group(tuple(self.mesh.axis_names))
        t = torch.tensor([float(seconds)], dtype=torch.float64,
                         device=self.device)
        if torch.distributed.get_backend(group) == "gloo":
            t = t.cpu()
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                     group=group)
        return float(t[0])

    def for_mesh(self, mesh: Optional[dctx.Mesh]) -> "Engine":
        """A fresh engine over the same model, run knobs and resolved
        ``strategy`` bound to ``mesh`` (a slice of ``slice_meshes``, or
        None): its own shape buckets and plan. The router's mesh-sliced
        pool gives every replica one (``router.pool.SlicePool``)."""
        return dataclasses.replace(self, mesh=mesh)

    def shard_inputs(self, batch):
        """This rank's rows of every input leaf (dim 0 cut over the data
        axes as ``dist.sharding.input_shardings`` plans it), as tensors
        on the engine's device; the whole batch without a mesh."""
        def one(x):
            x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            x = x.to(self.device)
            if self.mesh is None:
                return x
            return shd.rank_sharding(self._row_spec(x), self.mesh).slice(x)
        return tree_map(one, batch)

    def cache_sharding(self, cache):
        """The planned spec tree of ``cache`` (``dist.sharding.
        cache_shardings``, as :meth:`new_cache` lays it out: rows over
        every data axis or none, and the kv heads whole over "model"
        under "fsdp"); None without a mesh."""
        if self.mesh is None:
            return None
        plan = shd.cache_shardings(cache, self.model.cfg, self.mesh,
                                   seq_shard=self.seq_shard)
        keep_heads = self.strategy != "fsdp" or self.seq_shard

        def whole(spec):
            spec = shd.rows_all_or_none(spec, self.mesh)
            if keep_heads or len(spec) < 4:
                return spec
            return shd.drop_axis(spec, "model")
        if isinstance(plan, Cache):
            return dataclasses.replace(plan, layers=tuple(
                {name: whole(spec) for name, spec in layer.items()}
                for layer in plan.layers), lengths=whole(plan.lengths))
        return {name: tree_map(whole, specs, is_leaf=_is_spec)
                for name, specs in plan.items()}

    # -- the batch's rows over the data axes ---------------------------

    def _row_spec(self, x):
        """``dist.sharding.input_shardings``'s spec of batch ``x``, its
        rows cut over every data axis or none."""
        return shd.rows_all_or_none(shd.input_shardings(x, self.mesh),
                                    self.mesh)

    def _rows(self, x) -> Tuple[int, int]:
        """(blocks, this rank's block) of batch ``x``'s rows: D equal
        blocks over the data axes taken together where D divides the
        rows, else (1, 0), every rank computing every row."""
        if self.mesh is None:
            return 1, 0
        cut = shd.rank_sharding(self._row_spec(x), self.mesh).cuts[0]
        return (1, 0) if cut is None else (cut[2], cut[1])

    @staticmethod
    def _block(x, n: int, i: int):
        if n == 1:
            return x
        bl = x.shape[0] // n
        return x[i * bl:(i + 1) * bl]

    @staticmethod
    def _whole(x, n: int):
        """Every data shard's rows of ``x``, gathered (``x`` when
        whole)."""
        return x if n == 1 else collectives.data_gather(x)

    def _sample(self, logits, generator, b: int, n: int, i: int, kw: dict):
        """The fused epilogue on this rank's rows of a ``b``-row batch:
        the whole batch's noise is drawn (every rank's generator stays in
        step) and the rows' slice used."""
        noise = None
        if kw["temperature"] > 0.0 and n > 1:
            noise = self._block(gumbel_noise(
                (b, logits.shape[-1]), generator, logits.device), n, i)
        return fused_sample(logits, generator, noise=noise, **kw)

    def _seq_block(self, max_len: int) -> Tuple[int, int]:
        """(blocks the sequence of a ``max_len`` cache is cut into, this
        rank's block): ``dist.sharding.seq_blocks`` under a seq-shard mesh,
        else (1, 0)."""
        if not self.seq_shard:
            return 1, 0
        return shd.seq_blocks(self.mesh, max_len)

    def _frames(self, enc_embeds) -> dict:
        """``{"enc_embeds": ...}`` on the device for an encoder-decoder
        model (which needs them), ``{}`` for any other."""
        if not self.model.cfg.encdec:
            if enc_embeds is not None:
                raise ValueError(f"{self.model.cfg.name} takes no "
                                 f"enc_embeds")
            return {}
        if enc_embeds is None:
            raise ValueError(f"{self.model.cfg.name} is an encoder-decoder "
                             f"model: pass its frame embeddings "
                             f"(enc_embeds)")
        x = (enc_embeds if isinstance(enc_embeds, torch.Tensor)
             else torch.as_tensor(np.asarray(enc_embeds, np.float32)))
        return {"enc_embeds": x.to(self.device, torch.bfloat16)}

    def _tokens_in(self, tokens) -> torch.Tensor:
        """Token ids (array or tensor) as a long tensor on the device;
        host arrays are range-checked first (an id past the vocabulary
        would be a device-side fault on CUDA)."""
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device, torch.long)
        tokens = np.asarray(tokens)
        vocab = self.model.cfg.vocab_size
        if tokens.size and (tokens.min() < 0 or tokens.max() >= vocab):
            raise ValueError(f"token ids must lie in [0, {vocab})")
        return torch.tensor(tokens, dtype=torch.long, device=self.device)

    # ------------------------------------------------------------------
    # Shape buckets
    # ------------------------------------------------------------------

    def _get_exec(self, kind: str, key: tuple, build):
        fn = self._exec.get((kind, key))
        if fn is None:
            fn = build()
            self._exec[(kind, key)] = fn
            self.compile_count += 1
        return fn

    @property
    def warm(self) -> bool:
        """True once at least one shape bucket has been served."""
        return bool(self._exec)

    def _classify_fn(self):
        def _classify(params, tokens):
            n, i = self._rows(tokens)
            with dctx.row_shard(n, i):
                logits, _ = self.model.forward(
                    self.run, params, {"tokens": self._block(tokens, n, i)})
            return self._whole(logits, n)
        return _classify

    def _prefill_fn(self, max_len: int):
        shards, shard = self._seq_block(max_len)

        def _prefill(params, batch):  # tokens or embeddings (the dry run)
            n, i = self._rows(next(iter(batch.values())))
            with dctx.row_shard(n, i):
                logits, cache = self.model.prefill(
                    self.run, params,
                    {k: self._block(v, n, i) for k, v in batch.items()},
                    max_len=max_len, seq_shards=shards, shard=shard)
            if isinstance(cache, (Cache, EncDecCache)):
                cache.row_shards = n
            return self._whole(logits, n), cache
        return _prefill

    def _decode_fn(self, sample_kw: Optional[dict] = None):
        def _decode(params, cache, token, generator=None):
            n = getattr(cache, "row_shards", 1)
            i = dctx.dp_index(self.mesh) if n > 1 else 0
            with dctx.row_shard(n, i):
                logits, cache = self.model.decode_step(
                    self.run, params, cache,
                    {"token": self._block(token, n, i)})
            if sample_kw is not None:  # fused epilogue: (B,) tokens out
                toks = self._sample(logits, generator, token.shape[0], n, i,
                                    sample_kw)
                return self._whole(toks, n), cache
            return self._whole(logits, n), cache
        return _decode

    def _prefill_into_fn(self, cache, max_len: int,
                         sample_kw: Optional[dict] = None):
        shards = getattr(cache, "seq_shards", 1)
        shard = 0
        if shards > 1:  # a rank's block of the whole capacity: prefill it
            max_len = cache.kv_capacity()
            shards, shard = self._seq_block(max_len)
        vocab = self.model.cfg.vocab_size

        def _prefill_into(params, cache, batch, row, generator=None):
            # the row's owner: the data shard whose block holds it
            n, rows = cache.row_shards, cache.lengths.shape[0]
            owner, row = divmod(row, rows) if n > 1 else (0, row)
            own = n == 1 or owner == dctx.dp_index(self.mesh)
            # params cut over the data axes: every data shard runs the
            # layers, its gathers spanning them all, and only the owner
            # keeps the rows
            if own or self._gathers:
                with dctx.row_shard(1, 0):
                    logits, small = self.model.prefill(
                        self.run, params, batch, max_len=max_len,
                        seq_shards=shards, shard=shard)
                if own:  # KV rows (the prompt's), SSM state rows (whole)
                    _write_row(cache, small, row)
                out = (logits if sample_kw is None else self._sample(
                    logits, generator, 1, 1, 0, sample_kw))
            else:  # another shard's row: keep the generator in step
                if sample_kw is not None and sample_kw["temperature"] > 0:
                    gumbel_noise((1, vocab), generator, self.device)
                out = (torch.empty((1, vocab), dtype=torch.float32,
                                   device=self.device) if sample_kw is None
                       else torch.empty((1,), dtype=torch.int32,
                                        device=self.device))
            if n > 1:
                out = collectives.data_broadcast(out, owner)
            return out, cache
        return _prefill_into

    # ------------------------------------------------------------------
    # Classification (the paper's sentiment inference)
    # ------------------------------------------------------------------

    def classify(self, params, tokens) -> np.ndarray:
        """Batched classification. tokens: (B, S) int32 -> (B,) labels."""
        return np.argmax(self.classify_logits(params, tokens),
                         axis=-1).astype(np.int32)

    def classify_logits(self, params, tokens) -> np.ndarray:
        """(B, S) token ids -> (B, num_labels) fp32 logits on the host.

        The final copy to the host waits for the device, so a caller's
        clock around this call covers the device work.
        """
        tokens = np.asarray(tokens)
        device_tokens = self._tokens_in(tokens)
        fn = self._get_exec("classify", _shape_key(tokens),
                            self._classify_fn)
        with self._ctx(), torch.inference_mode():
            return fn(params, device_tokens).cpu().numpy()

    # ------------------------------------------------------------------
    # Prefill / decode
    # ------------------------------------------------------------------

    def prefill(self, params, tokens, *, max_len: Optional[int] = None,
                enc_embeds=None) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, S) -> (last-token logits (B, V), populated cache of
        capacity ``max_len``, default S + ``run.cache_pad``; under a
        seq-shard mesh, this rank's block of it). An encoder-decoder
        model takes its (B, S_enc, D) frame embeddings as ``enc_embeds``
        and returns an ``EncDecCache``."""
        tokens = self._tokens_in(tokens)
        b, s = tokens.shape
        if max_len is None:
            max_len = s + self.run.cache_pad
        _check_prompt(s, max_len)
        batch = {"tokens": tokens, **self._frames(enc_embeds)}
        fn = self._get_exec("prefill", (_shape_key(batch), max_len),
                            lambda: self._prefill_fn(max_len))
        with self._ctx(), torch.no_grad():
            return fn(params, batch)

    def decode(self, params, cache, token) -> Tuple[torch.Tensor, Any]:
        """One decode step, (B, 1) tokens -> ((B, V) logits, cache), on a
        dense ``Cache`` or a ``PagedCache`` (each its own bucket). The
        batch is RAGGED (each row at its own ``cache.lengths[b]``) and the
        cache is updated in place."""
        token = self._tokens_in(token)
        fn = self._get_exec("decode", _shape_key(cache), self._decode_fn)
        with self._ctx(), torch.no_grad():
            return fn(params, cache, token)

    # ------------------------------------------------------------------
    # Shared batched cache: allocation / row admission / row free
    # ------------------------------------------------------------------

    def new_cache(self, batch: int, max_len: int,
                  enc_len: Optional[int] = None):
        """Allocate an EMPTY shared batched decode cache (all lengths 0)
        on the engine's device: the backing store of continuous batching,
        admitted into by :meth:`prefill_into`, freed by :meth:`free_row`.
        Under a mesh it is this rank's slice of the planned layout
        (:meth:`cache_sharding`): no rank ever holds the whole cache. An
        encoder-decoder model's holds ``enc_len`` cross-attention
        positions (default ``max_len``).
        """
        if batch <= 0 or max_len <= 0:
            raise ValueError(
                f"new_cache needs positive batch/max_len, got "
                f"batch={batch} max_len={max_len}")
        if self.mesh is None:
            return self.model.init_cache(batch, max_len,
                                         kv_dtype=self.run.kv_dtype,
                                         device=self.device, enc_len=enc_len)
        # under a mesh the reference allocates through a pinned executable:
        # one more shape bucket, counted as it counts it
        specs = self.model.cache_specs(batch, max_len, self.run.kv_dtype,
                                       enc_len=enc_len)
        return self._get_exec("new_cache", _shape_key(specs),
                              lambda: lambda: self._alloc_cache(specs))()

    def _alloc_cache(self, specs):
        """Zeros of this rank's slice of every leaf of the whole cache
        ``specs`` (meta tensors), as :meth:`cache_sharding` lays it out."""
        plan = self.cache_sharding(specs)

        def zeros(t, spec):
            shape = shd.rank_sharding(spec, self.mesh).local_shape(t.shape)
            return torch.zeros(shape, dtype=t.dtype, device=self.device)
        b = specs.lengths.shape[0]
        if isinstance(specs, EncDecCache):
            out = {name: tuple(zeros(t, spec) for t, spec in zip(
                getattr(specs, name), plan[name]))
                for name in ("self_k", "self_v", "cross_k", "cross_v")}
            lengths = zeros(specs.lengths, plan["lengths"])
            return EncDecCache(**out, lengths=lengths,
                               row_shards=b // lengths.shape[0])
        layers = tuple({name: zeros(t, plan.layers[i][name])
                        for name, t in layer.items()}
                       for i, layer in enumerate(specs.layers))
        lengths = zeros(specs.lengths, plan.lengths)
        return Cache(layers=layers, lengths=lengths,
                     seq_shards=self._seq_block(specs.kv_capacity() or 0)[0],
                     row_shards=b // lengths.shape[0])

    def _row_len(self, cache: Cache, s: int, max_len: Optional[int]) -> int:
        """The prefill length of an admission: ``max_len``, default the
        shared cache's whole capacity (``Cache.kv_capacity``: axis 1 of
        the first attention layer's (B, T, KV, hd) leaves times its
        sequence blocks, where the reference reads axis 2 of a stacked KV
        leaf), or the prompt + ``run.cache_pad`` in a cache with no
        attention layer (all SSM: nothing there is sized by positions)."""
        cap = cache.kv_capacity()
        if max_len is None:
            max_len = s + self.run.cache_pad if cap is None else cap
        if cap is not None and max_len > cap:
            raise ValueError(f"max_len={max_len} exceeds the shared "
                             f"cache's capacity of {cap}")
        _check_prompt(s, max_len)
        return max_len

    def prefill_into(self, params, cache, row: int, tokens, *,
                     max_len: Optional[int] = None, enc_embeds=None
                     ) -> Tuple[torch.Tensor, Any]:
        """Admit one request into row ``row`` of a shared batched cache.

        tokens: (1, S). Prefills against the cache's capacity ``max_len``
        (inferred from the cache when omitted), then writes the KV rows
        and ``lengths[row] = S`` into the shared cache in place. One
        bucket per (cache, prompt shape), not per slot. An
        encoder-decoder model's admission encodes its (1, S_enc, D)
        ``enc_embeds`` (on the row's owners) and writes the row's cross
        K/V too. Returns (last-token logits (1, V), cache).
        """
        tokens = self._tokens_in(tokens)
        s = tokens.shape[1]
        max_len = self._row_len(cache, s, max_len)
        batch = {"tokens": tokens, **self._frames(enc_embeds)}
        fn = self._get_exec(
            "prefill_into", (_shape_key(cache), _shape_key(batch)),
            lambda: self._prefill_into_fn(cache, max_len))
        with self._ctx(), torch.no_grad():
            return fn(params, cache, batch, int(row))

    def _free_fn(self):
        def _free(cache, row):
            n = getattr(cache, "row_shards", 1)
            if n > 1:  # only the row's owner holds it
                owner, row = divmod(row, cache.lengths.shape[0])
                if owner != dctx.dp_index(self.mesh):
                    return cache
            cache.lengths[row] = 0
            if isinstance(cache, PagedCache):
                # paged eviction also nulls the row's page table, so its
                # inert per-round decode writes land in the reserved null
                # page 0, never in a page another row now owns
                cache.page_table[row] = 0
            return cache
        return _free

    def free_row(self, cache, row: int):
        """Evict row ``row``: reset its length to 0 (the per-row masks make
        a zero-length row inert; its stale KV is overwritten by the next
        admission) and, on a ``PagedCache``, zero its page table. In
        place; returns the cache."""
        fn = self._get_exec("free_row", _shape_key(cache), self._free_fn)
        with self._ctx():
            return fn(cache, int(row))

    # ------------------------------------------------------------------
    # Block-paged shared cache (page-table indirection + prefix sharing)
    # ------------------------------------------------------------------
    # Device half of the paged serving path; the host half (which row
    # owns which physical page, refcounts, prefix matching, the
    # copy-on-write barrier) is ``serving.paged.PageAllocator``. The
    # lifecycle the batcher drives: new_paged_cache -> (admit ->
    # assign_row_pages -> extend_row) per row -> decode (the same ragged
    # entry point: a PagedCache routes to the paged kernel) -> free_row.
    # Every call writes the pools, page table and lengths in place.

    def new_paged_cache(self, batch: int, n_pages: int, page_size: int,
                        max_pages: int) -> PagedCache:
        """Allocate an EMPTY paged cache on the engine's device: zeroed
        page pools (page 0 = reserved null page), all-null page tables,
        all lengths 0; int8 pools with scale pools under
        ``kv_dtype="int8"``. Single-host only: raises under a mesh."""
        if self.mesh is not None:
            raise ValueError(
                "paged KV caches are single-host only — use new_cache "
                "under a mesh (see serving/README.md)")
        if min(batch, n_pages, page_size, max_pages) <= 0:
            raise ValueError("paged cache dims must be positive")
        return self.model.init_paged_cache(batch, n_pages, page_size,
                                           max_pages,
                                           kv_dtype=self.run.kv_dtype,
                                           device=self.device)

    def _assign_fn(self):
        def _assign(cache, row, table_row, start_len):
            cache.page_table[row] = table_row
            cache.lengths[row] = start_len
            return cache
        return _assign

    def assign_row_pages(self, cache: PagedCache, row: int, pages,
                         start_len: int = 0) -> PagedCache:
        """Install ``row``'s logical -> physical page map (padded with the
        null page 0) and set its length to ``start_len``: the
        shared-prefix length on a warm admission, 0 cold, or the row's
        current length when reinstalling after a copy-on-write repoint.
        In place; one bucket per cache, not per slot."""
        max_pages = cache.page_table.shape[1]
        if len(pages) > max_pages:
            raise ValueError(f"{len(pages)} pages exceed the table's "
                             f"max_pages={max_pages}")
        table_row = np.zeros((max_pages,), np.int32)
        table_row[:len(pages)] = pages
        fn = self._get_exec("assign_row", _shape_key(cache),
                            self._assign_fn)
        return fn(cache, int(row), torch.from_numpy(table_row).to(
            self.device), int(start_len))

    def _check_chunk(self, cache: PagedCache, s: int):
        cap = cache.page_table.shape[1] * cache.page_size
        if s > cap:
            raise ValueError(
                f"{s}-token chunk exceeds the row capacity of {cap} "
                f"({cache.page_table.shape[1]} pages x {cache.page_size})")

    def _extend_fn(self, sample_kw: Optional[dict] = None):
        def _extend(params, cache, row, tokens, generator=None):
            logits, cache = self.model.extend_row(self.run, params, cache,
                                                  row, tokens)
            if sample_kw is not None:  # fused epilogue: (1,) token out
                return fused_sample(logits, generator, **sample_kw), cache
            return logits, cache
        return _extend

    def extend_row(self, params, cache: PagedCache, row: int, tokens
                   ) -> Tuple[torch.Tensor, PagedCache]:
        """Chunked prefill-with-history of one paged row: one call whether
        the row is cold (length 0, tokens = the full prompt) or warm
        (length = the shared-prefix length, tokens = the divergent suffix:
        the prefix pages are READ, not recomputed). The row's pages must
        already be installed (:meth:`assign_row_pages`). tokens: (1, L);
        returns (last-token logits (1, V), cache), written in place."""
        tokens = self._tokens_in(tokens)
        self._check_chunk(cache, tokens.shape[1])
        fn = self._get_exec("extend_row",
                            (_shape_key(cache), _shape_key(tokens)),
                            self._extend_fn)
        with torch.no_grad():
            return fn(params, cache, int(row), tokens)

    def _cow_fn(self):
        def _cow(cache, src, dst):
            for layer in cache.layers:
                for pool in layer.values():  # k, v and int8 scale pools
                    pool[dst].copy_(pool[src])
            return cache
        return _cow

    def cow_copy_page(self, cache: PagedCache, src: int, dst: int
                      ) -> PagedCache:
        """Copy physical page ``src`` -> ``dst`` in every layer's K and V
        pool (and scale pools): the device half of the allocator's
        copy-on-write barrier (``PageAllocator.writable_page`` decides
        WHEN; the caller then reinstalls the row's repointed table). In
        place."""
        fn = self._get_exec("cow_copy", _shape_key(cache), self._cow_fn)
        return fn(cache, int(src), int(dst))

    def _fork_fn(self):
        def _fork(cache, src, dst):
            cache.page_table[dst] = cache.page_table[src]
            cache.lengths[dst] = cache.lengths[src]
            return cache
        return _fork

    def fork_row(self, cache: PagedCache, src: int, dst: int) -> PagedCache:
        """Duplicate row ``src``'s page table and length into ``dst``
        WITHOUT copying any KV (best-of-N decoding: N rows continue from
        one prefill). Pair with ``PageAllocator.fork``: the shared partial
        tail page is copied on the first divergent write. In place."""
        fn = self._get_exec("fork_row", _shape_key(cache), self._fork_fn)
        return fn(cache, int(src), int(dst))

    # ------------------------------------------------------------------
    # Fused sampling (token ids out of the decode call: no separate
    # sampler step over the (B, V) logits)
    # ------------------------------------------------------------------

    def decode_sample(self, params, cache, token,
                      generator: Optional[torch.Generator], *,
                      temperature: float = 0.0,
                      top_k: Optional[int] = None,
                      top_p: Optional[float] = None
                      ) -> Tuple[torch.Tensor, Any]:
        """:meth:`decode` with the sampler fused in: returns ((B,) int32
        tokens, cache). From the same generator state the tokens equal
        ``sample`` over :meth:`decode`'s logits (on the card up to top-p
        cutoff near-ties). Sampling params are part of the bucket key."""
        token = self._tokens_in(token)
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        fn = self._get_exec(
            "decode_sample", (_shape_key(cache), (temperature, top_k,
                                                  top_p)),
            lambda: self._decode_fn(sample_kw=kw))
        with self._ctx(), torch.no_grad():
            return fn(params, cache, token, generator)

    def prefill_into_sample(self, params, cache, row: int, tokens,
                            generator: Optional[torch.Generator], *,
                            temperature: float = 0.0,
                            top_k: Optional[int] = None,
                            top_p: Optional[float] = None,
                            max_len: Optional[int] = None,
                            enc_embeds=None) -> Tuple[torch.Tensor, Any]:
        """:meth:`prefill_into` with the first sampled token fused in.
        Returns ((1,) int32 token, cache)."""
        tokens = self._tokens_in(tokens)
        s = tokens.shape[1]
        max_len = self._row_len(cache, s, max_len)
        batch = {"tokens": tokens, **self._frames(enc_embeds)}
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        fn = self._get_exec(
            "prefill_into_sample",
            (_shape_key(cache), _shape_key(batch),
             (temperature, top_k, top_p)),
            lambda: self._prefill_into_fn(cache, max_len, sample_kw=kw))
        with self._ctx(), torch.no_grad():
            return fn(params, cache, batch, int(row), generator)

    def extend_row_sample(self, params, cache: PagedCache, row: int, tokens,
                          generator: Optional[torch.Generator], *,
                          temperature: float = 0.0,
                          top_k: Optional[int] = None,
                          top_p: Optional[float] = None
                          ) -> Tuple[torch.Tensor, PagedCache]:
        """:meth:`extend_row` with the first sampled token fused in.
        Returns ((1,) int32 token, cache)."""
        tokens = self._tokens_in(tokens)
        self._check_chunk(cache, tokens.shape[1])
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        fn = self._get_exec(
            "extend_row_sample",
            (_shape_key(cache), _shape_key(tokens),
             (temperature, top_k, top_p)),
            lambda: self._extend_fn(sample_kw=kw))
        with torch.no_grad():
            return fn(params, cache, int(row), tokens, generator)

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    def generate(self, params, tokens, *, max_new_tokens: int = 16,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 max_len: Optional[int] = None,
                 fused_sampling: bool = False) -> np.ndarray:
        """Greedy/temperature generation. tokens: (B, S) -> (B, S+new).

        Prefill, then one decode call per new token; sampled tokens stay
        on the device until the final concatenation. The noise comes from
        one ``torch.Generator`` seeded with ``seed``, one draw per token
        in both modes, so at the same seed ``fused_sampling=True``
        (:meth:`decode_sample`) emits the host path's stream (on the card
        up to top-p cutoff near-ties).
        """
        prompt = self._tokens_in(tokens)
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        logits, cache = self.prefill(params, prompt, max_len=max_len)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            if fused_sampling:
                tok = fused_sample(logits, gen, **kw)[:, None]
            else:
                tok = sample(logits, gen, **kw)[:, None]
        outs = [prompt.to(torch.int32)]
        for _ in range(max_new_tokens - 1):
            outs.append(tok)
            if fused_sampling:
                toks, cache = self.decode_sample(params, cache, tok, gen,
                                                 **kw)
                tok = toks[:, None]
            else:
                logits, cache = self.decode(params, cache, tok)
                with torch.no_grad():
                    tok = sample(logits, gen, **kw)[:, None]
        outs.append(tok)
        return torch.cat(outs, dim=1).cpu().numpy()
