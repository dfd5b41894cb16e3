"""STEVE: slot-attention video autoencoder, inference (counterpart of
``focus_tpu/models/steve/steve.py``; reference
``slowfast/models/STEVE/steve.py:253-392``).

Video tensors are ``[B, T, H, W, C]`` as in the JAX package; the CNNs run
NCHW inside. Ported: ``encode`` (CNN, slot attention over video) and
``decode`` (the autoregressive token rollout, then the dVAE decoder), that
is ``reconstruct_autoregressive``. The rollout has three forms:

- ``_decode_ids_cached_fused``: one fused step per token
  (``ops/ar_decode.py``: the CUDA kernels on the card, their plain version
  on the CPU or when ``use_kernels`` is False), the W8A8 step under
  ``TPU.INT8_SERVING``; on the card one captured CUDA graph of all its
  steps is replayed per rollout (``ar_decode.RolloutGraph``);
- ``_decode_ids_cached``: the KV-cached rollout through the modules;
- ``_decode_ids_full``: the full-prefix re-decode, the parity oracle.

The training forward (Gumbel noise, losses) is not ported yet.
"""

import copy

import torch
import torch.nn.functional as F
from torch import nn

from focus_tpu_torch.models.build import register
from focus_tpu_torch.models.common import (
    LN_EPS,
    Conv2dBlock,
    Dense,
    TransformerDecoder,
    conv,
    conv2d,
    ffn,
    layer_norm,
    linear,
)
from focus_tpu_torch.models.steve.dvae import DVAE
from focus_tpu_torch.models.steve.slot_attention import SlotAttentionVideo
from focus_tpu_torch.ops import ar_decode


class CartesianPositionalEmbedding(nn.Module):
    """Adds a projected 4-channel (x, y, 1-x, 1-y) grid of cell centres
    (reference steve.py:125-145). NCHW."""

    def __init__(self, channels, image_size):
        super().__init__()
        self.image_size = image_size
        self.projection = conv2d(4, channels, 1)

    def grid(self, device, dtype):
        edges = torch.linspace(0.0, 1.0, self.image_size + 1, device=device)
        centres = 0.5 * (edges[:-1] + edges[1:])
        gy, gx = torch.meshgrid(centres, centres, indexing="ij")
        return torch.stack((gx, gy, 1 - gx, 1 - gy), dim=0)[None].to(dtype)

    def forward(self, x):
        return x + conv(self.grid(x.device, x.dtype), self.projection)


class LearnedPositionalEmbedding1D(nn.Module):
    """(reference steve.py:108-122). ``at`` adds the embedding of one
    position (KV-cached decode). The sum is float32, as the table is."""

    def __init__(self, num_inputs, input_size):
        super().__init__()
        self.pe = nn.Parameter(torch.empty(1, num_inputs, input_size))

    def at(self, x_t, t):
        return x_t + self.pe[:, t:t + 1]

    def forward(self, x):
        return x + self.pe[:, :x.shape[1]]


class BaseCNN(nn.Module):
    """Stack of 5x5 conv blocks (reference steve.py:162-173). NCHW."""

    def __init__(self, img_size, hid, out_dim, img_channels=3):
        super().__init__()
        stride0 = 1 if img_size == 64 else 2
        self.fenc = nn.Sequential(
            Conv2dBlock(img_channels, hid, 5, stride0, 2),
            Conv2dBlock(hid, hid, 5, 1, 2),
            Conv2dBlock(hid, hid, 5, 1, 2),
            conv2d(hid, out_dim, 5, 1, 2),
        )

    def forward(self, x):
        for blk in self.fenc[:3]:
            x = blk(x)
        return conv(x, self.fenc[3])


def batch_norm(x, bn: nn.BatchNorm2d):
    """Eval BatchNorm (running statistics) in float32, result at x's
    dtype."""
    return F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps).to(x.dtype)


def _plain_conv(in_channels, out_channels, bias):
    layer = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=bias)
    layer.init = ("lecun", 1.0)
    return layer


class _BasicBlock(nn.Module):
    """ResNet-18 basic block: two 3x3 conv + BN with identity skip."""

    def __init__(self, features):
        super().__init__()
        self.conv1 = _plain_conv(features, features, bias=False)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv2 = _plain_conv(features, features, bias=False)
        self.bn2 = nn.BatchNorm2d(features, eps=1e-5)

    def forward(self, x):
        y = F.relu(batch_norm(conv(x, self.conv1), self.bn1))
        y = batch_norm(conv(y, self.conv2), self.bn2)
        return F.relu(x + y)


class Res18Stem(nn.Module):
    """ResNet-18 stem (3x3/s1 conv1) + layer1, then a stride-2 transposed
    conv back to full resolution (reference steve.py:175-202). NCHW, eval
    BatchNorm. The JAX module's ``ConvTranspose(3x3, stride 2, "SAME")``
    pads the dilated input by (2, 1) and does not flip its kernel; here
    that is ``ConvTranspose2d(padding=0)`` cropped to twice the input size,
    with the kernel flipped when weights are carried across
    (``utils/weights.py``)."""

    def __init__(self, hid, out_dim, img_channels=3):
        super().__init__()
        self.conv1 = _plain_conv(img_channels, hid, bias=True)
        self.bn1 = nn.BatchNorm2d(hid, eps=1e-5)
        self.layer1_0 = _BasicBlock(hid)
        self.layer1_1 = _BasicBlock(hid)
        self.upconv = nn.ConvTranspose2d(hid, out_dim, 3, stride=2)
        self.upconv.init = ("lecun", 1.0)

    def forward(self, x):
        x = F.relu(batch_norm(conv(x, self.conv1), self.bn1))
        x = F.max_pool2d(x, 3, 2, 1)
        x = F.relu(self.layer1_1(self.layer1_0(x)))
        h, w = x.shape[-2:]
        up = self.upconv
        y = F.conv_transpose2d(x, up.weight.to(x.dtype), up.bias.to(x.dtype),
                               stride=2)
        return y[..., :2 * h, :2 * w]


class STEVEEncoder(nn.Module):
    """Visual CNN + cartesian pos-emb + MLP + SlotAttentionVideo
    (reference steve.py:213-234)."""

    def __init__(self, cfg):
        super().__init__()
        c = cfg.SLOTS
        d = c.DECODER.DIM
        if cfg.MODEL.CNN_NAME == "base":
            self.cnn = BaseCNN(c.IMG_SIZE, c.CNN_HID_SIZE, d, c.IMG_CHANNELS)
        elif cfg.MODEL.CNN_NAME == "res18":
            self.cnn = Res18Stem(c.CNN_HID_SIZE, d, c.IMG_CHANNELS)
        else:
            raise ValueError(f"Unknown CNN_NAME: {cfg.MODEL.CNN_NAME}")
        pos_size = c.IMG_SIZE if c.IMG_SIZE == 64 else c.IMG_SIZE // 2
        self.pos = CartesianPositionalEmbedding(d, pos_size)
        self.layer_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp = nn.Sequential(Dense(d, d, weight_init="kaiming"),
                                 nn.ReLU(), Dense(d, d))
        # the tokens are DECODER.DIM wide; the JAX modules infer their input
        # width and never read SLOTS.DIM, which they are handed here
        self.savi = SlotAttentionVideo(
            c.NUM_ITERS, c.NUM_SLOTS, d, c.SIZE, c.MLP_HID_SIZE,
            c.NUM_PREDICTOR_BLOCKS, c.NUM_PREDICTOR_HEADS,
            c.PREDICTOR_DROPOUT,
        )
        self.slot_proj = Dense(c.SIZE, d, bias=False)

    def embed(self, video_flat):
        """CNN features -> tokens. video_flat [B*T, H, W, C] ->
        ([B*T, h*w, d], (h, w))."""
        emb = self.pos(self.cnn(video_flat.permute(0, 3, 1, 2)))
        h, w = emb.shape[-2:]
        tokens = emb.flatten(2).transpose(1, 2)
        return ffn(layer_norm(tokens, self.layer_norm), self.mlp), (h, w)


class _Dictionary(nn.Module):
    """The token dictionary (upstream ``OneHotDictionary``), looked up by
    id."""

    def __init__(self, vocab_size, emb_size):
        super().__init__()
        self.dictionary = nn.Embedding(vocab_size, emb_size)

    def forward(self, ids):
        return self.dictionary(ids)


class STEVEDecoder(nn.Module):
    """Token dictionary + BOS + learned pos-emb + causal transformer + head
    (reference steve.py:237-251)."""

    def __init__(self, cfg, dtype=None):
        super().__init__()
        c = cfg.SLOTS
        d = c.DECODER.DIM
        self.dict = _Dictionary(c.VOCAB_SIZE, d)
        self.bos = nn.Parameter(torch.empty(1, 1, d))
        self.pos = LearnedPositionalEmbedding1D(1 + (c.IMG_SIZE // 4) ** 2, d)
        self.tf = TransformerDecoder(c.DECODER.NUM_BLOCKS, d,
                                     c.DECODER.NUM_HEADS, c.DECODER.DROPOUT,
                                     dtype=dtype)
        self.head = Dense(d, c.VOCAB_SIZE, bias=False)


@register
class STEVE(nn.Module):
    """STEVE video autoencoder, inference (reference steve.py:253-392).

    ``reconstruct_autoregressive(video) -> recon [B, T, H, W, C]`` in
    [0, 1]; ``encode(video) -> (slots, attns_vis, attns)``;
    ``decode(slots) -> pixels``. ``use_kernels = False`` runs the fused
    rollout on the plain version of its kernels. On the card the fused
    rollout replays a CUDA graph of all its steps, captured once per rows,
    mode, length, dtype and logits flag (``free_rollout_graphs`` drops
    them); ``rollout_graphs = False`` launches it step by step instead.
    """

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        c = cfg.SLOTS
        self.dtype = dtype
        self.vocab_size, self.num_slots = c.VOCAB_SIZE, c.NUM_SLOTS
        self.image_size, self.d_model = c.IMG_SIZE, c.DECODER.DIM
        self.fused_ar_step = bool(cfg.TPU.FUSED_AR_STEP)
        # the W8A8 fused step (a labeled serving variant); as in the JAX
        # package it reaches only the fused rollout
        self.int8_serving = bool(cfg.TPU.INT8_SERVING)
        self.use_kernels = True
        self.rollout_graphs = True
        self._rollout_cache = {}  # kind -> (weights' fingerprint, value)
        self._rollout_graphs = {}  # ar_decode.rollout_graph_key -> graph
        self.dvae = DVAE(c.VOCAB_SIZE, c.IMG_CHANNELS)
        self.steve_encoder = STEVEEncoder(cfg)
        self.steve_decoder = STEVEDecoder(cfg, dtype=dtype)

    def forward(self, video, tau=None, hard=None, train=False):
        raise NotImplementedError(
            "the STEVE training forward (Gumbel noise, losses) is not ported "
            "yet; call encode / decode / reconstruct_autoregressive")

    def _slot_pipeline(self, video, noise=None, generator=None):
        """CNN -> tokens -> slot attention: slots [B, T, S, slot_size] and
        the attention maps upsampled to pixels [B, T, S, H, W, 1]."""
        B, T, H, W, C = video.shape
        flat = video.reshape(B * T, H, W, C).to(self.dtype)
        tokens, (h_enc, w_enc) = self.steve_encoder.embed(flat)
        tokens = tokens.reshape(B, T, h_enc * w_enc, self.d_model)
        slots, attns = self.steve_encoder.savi(tokens, noise, generator)
        attns = attns.transpose(2, 3).reshape(
            B, T, self.num_slots, h_enc, w_enc, 1)
        attns = attns.repeat_interleave(H // h_enc, dim=3)
        attns = attns.repeat_interleave(W // w_enc, dim=4)
        return slots, attns

    @torch.no_grad()
    def encode(self, video, noise=None, generator=None):
        """(reference steve.py:332-357): slots, the video masked by each
        slot's attention, and the attention maps. ``noise`` [B, S, D] fixes
        the slot initialisation; else it is drawn from ``generator``."""
        slots, attns = self._slot_pipeline(video, noise, generator)
        attns_vis = video[:, :, None] * attns + (1.0 - attns)
        return slots, attns_vis, attns

    @torch.no_grad()
    def decode_ids(self, slots, use_kv_cache=True, logits=None):
        """Token ids [gen_len, B] of the rollout from ``slots`` [B, S,
        slot_size]. With the KV cache the fused step runs when
        ``TPU.FUSED_AR_STEP`` is set, at every row count; without it the
        full-prefix oracle. ``logits`` (float32 [gen_len, B, V], fused
        step only) receives every step's vocabulary logits."""
        gen_len = (self.image_size // 4) ** 2
        slots = linear(slots.to(self.dtype), self.steve_encoder.slot_proj)
        if use_kv_cache and self.fused_ar_step:
            return self._decode_ids_cached_fused(slots, gen_len, logits)
        if logits is not None:
            raise ValueError("only the fused step returns its logits")
        if use_kv_cache:
            return self._decode_ids_cached(slots, gen_len)
        return self._decode_ids_full(slots, gen_len)

    @torch.no_grad()
    def decode(self, slots, use_kv_cache=True):
        """Autoregressive token rollout -> pixels [B, H, W, C]
        (reference steve.py:359-381)."""
        B = slots.shape[0]
        side = self.image_size // 4
        z_ids = self.decode_ids(slots, use_kv_cache)
        z_grid = F.one_hot(z_ids.t().long(), self.vocab_size).to(
            self.dtype).reshape(B, side, side, self.vocab_size)
        return self.dvae.decoder(z_grid).clamp(0.0, 1.0)

    def _cached(self, kind, make):
        """``make()`` once per state of the decoder's weights: the value is
        kept with the parameters' storage addresses and version counters and
        made again when a load, an in-place update or a move changed one."""
        key = tuple((p.data_ptr(), p._version)
                    for p in self.steve_decoder.parameters())
        hit = self._rollout_cache.get(kind)
        if hit is None or hit[0] != key:
            hit = self._rollout_cache[kind] = (key, make())
        return hit[1]

    def _rollout_decoder(self, dtype):
        """The decoder with its dense weights at ``dtype``: cast once per
        state of the weights, not once per step or rollout."""
        if dtype == torch.float32:
            return self.steve_decoder

        def cast():
            dec = copy.deepcopy(self.steve_decoder)
            for m in dec.modules():
                if isinstance(m, nn.Linear):
                    m.to(dtype)
            return dec

        return self._cached(("modules", dtype), cast)

    def _packed_decoder(self, dtype, w8a8=False):
        """The decoder's weights as the fused step reads them, packed once
        per state of the weights; ``w8a8``: the W8A8 pack, quantized from
        the pack at ``dtype`` and kept beside it."""
        dec = self.steve_decoder
        if w8a8:
            return self._cached(("packed_w8a8", dtype), lambda: (
                ar_decode.quantize_packed(self._packed_decoder(dtype))))
        return self._cached(("packed", dtype), lambda: (
            ar_decode.stack_decoder_params(dec.tf, dec.head,
                                           dec.dict.dictionary, dtype)))

    def free_rollout_graphs(self):
        """Drop the captured rollouts and the static buffers they own."""
        self._rollout_graphs.clear()

    def _rollout_graph(self, packed, rows, gen_len, dtype, with_logits,
                       device):
        """The captured rollout for this shape and mode, captured again
        when the weights' pack changed."""
        key = ar_decode.rollout_graph_key(rows, self.int8_serving, gen_len,
                                          dtype, with_logits)
        graph = self._rollout_graphs.get(key)
        if graph is None or graph.packed is not packed:
            self._rollout_graphs.pop(key, None)  # its buffers go first
            tf = self.steve_decoder.tf
            graph = self._rollout_graphs[key] = ar_decode.RolloutGraph(
                packed, tf.num_heads, rows, self.d_model, self.num_slots,
                gen_len, device, with_logits=with_logits, dtype=dtype)
        return graph

    def _bos(self, slots):
        B = slots.shape[0]
        return self.steve_decoder.bos.to(slots.dtype).expand(B, 1, self.d_model)

    def _decode_ids_cached(self, slots, gen_len):
        """KV-cached rollout through the modules: step t runs the decoder
        on one token against per-layer caches [B, L, h, hd]."""
        B, d, dtype = slots.shape[0], self.d_model, slots.dtype
        dec = self._rollout_decoder(dtype)
        h = dec.tf.num_heads
        L = 1 + gen_len
        x = self._bos(slots)
        caches = tuple(
            (torch.zeros(B, L, h, d // h, dtype=dtype, device=slots.device),
             torch.zeros(B, L, h, d // h, dtype=dtype, device=slots.device))
            for _ in range(dec.tf.num_blocks))
        # slots are constant through the rollout: project each layer's
        # cross-attention K/V once
        cross_kvs = dec.tf(x, slots, project_kv_only=True)
        ids = []
        for t in range(gen_len):
            out, caches = dec.tf(dec.pos.at(x, t), slots, caches=caches, t=t,
                                 cross_kvs=cross_kvs)
            z = linear(out, dec.head).argmax(dim=-1)  # [B, 1]
            x = dec.dict(z).to(dtype)
            ids.append(z[:, 0])
        return torch.stack(ids)

    def _decode_ids_cached_fused(self, slots, gen_len, logits=None):
        """KV-cached rollout with the whole per-token decoder body, the
        token head, the argmax and the dictionary lookup in one fused step
        (W8A8 under ``int8_serving``, at every row count: the JAX package
        gates its fused step to 64 rows or fewer and rolls larger batches
        out in bf16). Outside the step stay the hoisted cross-attention K/V,
        once per rollout, and the weight packing, once per state of the
        weights. On the card (``use_kernels`` and ``rollout_graphs``) the
        steps are one replay of a captured graph, whose ids and logits are
        those of the step-by-step launches bit for bit."""
        B, d, dtype = slots.shape[0], self.d_model, slots.dtype
        dec = self.steve_decoder
        nb, L = dec.tf.num_blocks, 1 + gen_len
        packed = self._packed_decoder(dtype, w8a8=self.int8_serving)
        pos = dec.pos.pe[0, :L].float().contiguous()
        bos = self._bos(slots)
        cross_kvs = dec.tf(bos, slots, project_kv_only=True)
        ckv = torch.stack([
            torch.stack([k.reshape(B, -1, d), v.reshape(B, -1, d)])
            for k, v in cross_kvs]).to(dtype).contiguous()  # [nb, 2, B, S, d]
        k_cache = torch.zeros(nb, L, B, d, dtype=dtype, device=slots.device)
        v_cache = torch.zeros_like(k_cache)
        x = bos[:, 0].contiguous()
        if (self.use_kernels and self.rollout_graphs
                and slots.device.type == "cuda"):
            graph = self._rollout_graph(packed, B, gen_len, dtype,
                                        logits is not None, slots.device)
            return graph.run(x, ckv, pos, logits).long()
        ids = []
        if self.use_kernels:
            step = ar_decode.fused_ar_step
            extra = {"scratch": ar_decode.workspace(B, d, slots.device,
                                                    self.int8_serving)}
        else:
            step, extra = ar_decode.ar_step_reference, {}
        for t in range(gen_len):
            x, z, _, _ = step(
                x, t, packed, ckv, k_cache, v_cache, pos, dec.tf.num_heads,
                logits_out=None if logits is None else logits[t], **extra)
            ids.append(z)
        return torch.stack(ids).long()

    def _decode_ids_full(self, slots, gen_len):
        """Full-prefix re-decode (the reference's own form), the oracle."""
        B, d, dtype = slots.shape[0], self.d_model, slots.dtype
        dec = self._rollout_decoder(dtype)
        buf = torch.zeros(B, 1 + gen_len, d, dtype=dtype, device=slots.device)
        buf[:, :1] = self._bos(slots)
        ids = []
        for t in range(gen_len):
            # positions > t are masked out of every row <= t: not computed
            out = dec.tf(dec.pos(buf[:, :t + 1]), slots)
            z = linear(out[:, t:t + 1], dec.head).argmax(dim=-1)
            buf[:, t + 1:t + 2] = dec.dict(z).to(dtype)
            ids.append(z[:, 0])
        return torch.stack(ids)

    @torch.no_grad()
    def reconstruct_autoregressive(self, video, use_kv_cache=True, noise=None,
                                   generator=None):
        """(reference steve.py:383-392)"""
        B, T, H, W, C = video.shape
        slots, _, _ = self.encode(video, noise, generator)
        recon = self.decode(slots.reshape(B * T, self.num_slots, -1),
                            use_kv_cache=use_kv_cache)
        return recon.reshape(B, T, H, W, C)
