"""Seq2seq grapheme-to-phoneme model (port of
``fastspeech2_tpu/text/neural_g2p.py``).

A tiny pre-LN transformer encoder-decoder (chars -> ARPAbet with stress)
that the synthesis frontend consults for words missing from the lexicon,
ahead of the rule engine (text/letter_to_sound.py).  It reads the JAX
package's trained weights in place (fastspeech2_tpu/text/data/
g2p_seq2seq.npz) and reproduces its arithmetic: Flax LayerNorm (eps 1e-6),
Flax multi-head attention (query scaled by 1/sqrt(d) before the product,
masked logits set to the float32 minimum), and the same greedy and beam
decoders over a fixed MAX_PRON-token window.  The encoder runs once per
word; the JAX package recomputes it every step, with the same result.

One set of functions (:func:`encode`, :func:`decode`) computes the model
from a flat dict of tensors keyed by the npz names
("enc_0/SelfAttention_0/query/kernel", ...): the decoders of
:class:`NeuralG2P` call them on the loaded weights, and
:class:`G2PModel`, the trainable module of ``text/train_g2p.py``, on its
parameters.  Training adds the Flax model's dropout: on the embeddings,
on the attention weights (one mask shared over the batch and the heads,
Flax's ``broadcast_dropout``) and after the feed-forward ReLU.
"""

import os

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from fastspeech2_tpu_torch.text.cmudict import valid_symbols

# ---- vocabularies (identical to the JAX package's) ----
CHARS = list("abcdefghijklmnopqrstuvwxyz'-.")
CHAR_PAD = 0
CHAR_TO_ID = {c: i + 1 for i, c in enumerate(CHARS)}
N_CHARS = len(CHARS) + 1

PH_PAD, PH_BOS, PH_EOS = 0, 1, 2
PHONES = list(valid_symbols)
PH_TO_ID = {p: i + 3 for i, p in enumerate(PHONES)}
ID_TO_PH = {i + 3: p for i, p in enumerate(PHONES)}
N_PHONES = len(PHONES) + 3

MAX_WORD = 28
MAX_PRON = 28
D = 128
HEADS = 4
LAYERS = 2
FF = 256

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_WEIGHTS = os.path.join(REPO_ROOT, "fastspeech2_tpu", "text", "data",
                               "g2p_seq2seq.npz")


def encode_word(word):
    """word -> [MAX_WORD] char ids (0-padded), or None if unencodable."""
    ids = [CHAR_TO_ID.get(c) for c in word.lower()[:MAX_WORD]]
    ids = [i for i in ids if i is not None]
    if not ids:
        return None
    return np.asarray(ids + [CHAR_PAD] * (MAX_WORD - len(ids)), np.int64)


def encode_phones(phones):
    """[phones] -> [MAX_PRON] decoder target ids (EOS-terminated)."""
    ids = [PH_TO_ID[p] for p in phones if p in PH_TO_ID][: MAX_PRON - 1]
    ids = ids + [PH_EOS]
    return np.asarray(ids + [PH_PAD] * (MAX_PRON - len(ids)), np.int64)


def load_params(path, device):
    """npz ("enc_0/SelfAttention_0/query/kernel", ...) -> flat dict of
    float32 tensors on ``device``."""
    with np.load(path) as data:
        return {k: torch.as_tensor(data[k].astype(np.float32), device=device)
                for k in data.files}


def save_params(path, params):
    """npz name -> tensor (or array) -> a float16 npz of the JAX package's
    layout (``fastspeech2_tpu/text/neural_g2p.py:230-245``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{
        k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v,
                      np.float16) for k, v in params.items()})


def available(weights_path=DEFAULT_WEIGHTS):
    return os.path.exists(weights_path)


def _layer_norm(p, name, x, eps=1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + eps) * p[name + "/scale"]
    return (x - mean) * mul + p[name + "/bias"]


def _dense(p, name, x):
    return x @ p[name + "/kernel"] + p[name + "/bias"]


def _attention(p, name, q_in, kv_in, mask, dropout=None):
    """Flax MultiHeadDotProductAttention; mask [B, 1, Lq, Lk] bool;
    ``dropout`` (training) falls on the attention weights."""
    def proj(part, x):
        # DenseGeneral: [B, L, D] x [D, H, d] + [H, d] -> [B, L, H, d]
        return (torch.einsum("bld,dhk->blhk", x, p[f"{name}/{part}/kernel"])
                + p[f"{name}/{part}/bias"])

    q, k, v = proj("query", q_in), proj("key", kv_in), proj("value", kv_in)
    q = q / np.float32(np.sqrt(q.shape[-1]))
    w = torch.einsum("bqhd,bkhd->bhqk", q, k)
    w = torch.where(mask, w, torch.finfo(torch.float32).min)
    w = torch.softmax(w, dim=-1)
    if dropout is not None:
        w = dropout(w, shared=True)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return (torch.einsum("bqhd,hdo->bqo", out, p[f"{name}/out/kernel"])
            + p[f"{name}/out/bias"])


def _block(p, name, x, mask, ctx=None, ctx_mask=None, dropout=None):
    h = _layer_norm(p, f"{name}/LayerNorm_0", x)
    x = x + _attention(p, f"{name}/SelfAttention_0", h, h, mask, dropout)
    ln = 1
    if ctx is not None:
        h = _layer_norm(p, f"{name}/LayerNorm_1", x)
        c = _layer_norm(p, f"{name}/LayerNorm_2", ctx)
        x = x + _attention(p, f"{name}/MultiHeadDotProductAttention_0", h, c,
                           ctx_mask, dropout)
        ln = 3
    h = _layer_norm(p, f"{name}/LayerNorm_{ln}", x)
    h = torch.relu(_dense(p, f"{name}/Dense_0", h))
    if dropout is not None:
        h = dropout(h)
    return x + _dense(p, f"{name}/Dense_1", h)


def _pair_mask(q_keep, k_keep):
    return (q_keep[:, :, None] & k_keep[:, None, :])[:, None]


def encode(p, chars, dropout=None):
    """chars [B, Lc] -> (encoder output [B, Lc, D], the chars' keep
    mask)."""
    cmask = chars != CHAR_PAD
    x = p["char_emb/embedding"][chars] + p["pos_enc"][None, : chars.shape[1]]
    if dropout is not None:
        x = dropout(x)
    mask = _pair_mask(cmask, cmask)
    for i in range(LAYERS):
        x = _block(p, f"enc_{i}", x, mask, dropout=dropout)
    return _layer_norm(p, "enc_norm", x), cmask


def decode(p, enc, cmask, dec_in, dropout=None):
    """Teacher tokens [B, Lp] over the encoder output -> logits
    [B, Lp, N_PHONES], causally masked."""
    dmask = dec_in != PH_PAD
    y = p["ph_emb/embedding"][dec_in] + p["pos_dec"][None, : dec_in.shape[1]]
    if dropout is not None:
        y = dropout(y)
    n = dec_in.shape[1]
    causal = torch.tril(torch.ones(n, n, dtype=torch.bool,
                                   device=dec_in.device))
    self_mask = causal[None, None] & _pair_mask(dmask, dmask)
    cross_mask = _pair_mask(dmask, cmask)
    for i in range(LAYERS):
        y = _block(p, f"dec_{i}", y, self_mask, enc, cross_mask, dropout)
    return _dense(p, "out", _layer_norm(p, "dec_norm", y))


def param_shapes():
    """The Flax model's parameters: npz name -> shape."""
    shapes = {"char_emb/embedding": (N_CHARS, D), "pos_enc": (MAX_WORD, D),
              "ph_emb/embedding": (N_PHONES, D), "pos_dec": (MAX_PRON, D),
              "enc_norm/scale": (D,), "enc_norm/bias": (D,),
              "dec_norm/scale": (D,), "dec_norm/bias": (D,),
              "out/kernel": (D, N_PHONES), "out/bias": (N_PHONES,)}
    for stack, cross in (("enc", False), ("dec", True)):
        for i in range(LAYERS):
            b = f"{stack}_{i}"
            attns = ["SelfAttention_0"]
            if cross:
                attns.append("MultiHeadDotProductAttention_0")
            for a in attns:
                for part in ("query", "key", "value"):
                    shapes[f"{b}/{a}/{part}/kernel"] = (D, HEADS, D // HEADS)
                    shapes[f"{b}/{a}/{part}/bias"] = (HEADS, D // HEADS)
                shapes[f"{b}/{a}/out/kernel"] = (HEADS, D // HEADS, D)
                shapes[f"{b}/{a}/out/bias"] = (D,)
            for n in range(4 if cross else 2):
                shapes[f"{b}/LayerNorm_{n}/scale"] = (D,)
                shapes[f"{b}/LayerNorm_{n}/bias"] = (D,)
            shapes[f"{b}/Dense_0/kernel"] = (D, FF)
            shapes[f"{b}/Dense_0/bias"] = (FF,)
            shapes[f"{b}/Dense_1/kernel"] = (FF, D)
            shapes[f"{b}/Dense_1/bias"] = (D,)
    return shapes


def _flax_init(name, shape, gen):
    """A draw from the distribution of parameter ``name``'s Flax
    initializer: Embed N(0, 1/features); Dense and attention kernels
    lecun_normal (a normal truncated at 2 std, std sqrt(1/fan_in) /
    0.8796..., fan_in the input dims, flattened as DenseGeneral flattens
    them); the position tables N(0, 0.02); LayerNorm scales 1; biases 0."""
    leaf = name.rsplit("/", 1)[-1]
    if leaf == "embedding":
        return torch.randn(shape, generator=gen) / np.sqrt(shape[1])
    if name in ("pos_enc", "pos_dec"):
        return torch.randn(shape, generator=gen) * 0.02
    if leaf == "scale":
        return torch.ones(shape)
    if leaf == "bias":
        return torch.zeros(shape)
    # [in, out], [D, H, d] (query/key/value) or [H, d, D] (out)
    fan_in = shape[0] * shape[1] if name.endswith("/out/kernel") \
        and len(shape) == 3 else shape[0]
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=gen)
    return t * (np.sqrt(1.0 / fan_in) / 0.87962566103423978)


class _Dropout:
    """Flax dropout at ``rate`` from ``generator``: keep each element with
    probability 1 - rate and scale the kept ones by 1 / (1 - rate);
    ``shared`` draws one mask over the leading two axes (the attention
    weights' batch and heads)."""

    def __init__(self, rate, generator=None):
        self.rate = rate
        self.generator = generator

    def __call__(self, x, shared=False):
        shape = (1, 1) + tuple(x.shape[2:]) if shared else x.shape
        keep = torch.rand(shape, generator=self.generator,
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class G2PModel(nn.Module):
    """The trainable G2P: chars [B, Lc] + teacher tokens [B, Lp] ->
    logits [B, Lp, N_PHONES], with the Flax model's structure and
    parameter names (``fastspeech2_tpu/text/neural_g2p.py:59-128``: D 128,
    4 heads, 2 + 2 blocks, FF 256, LayerNorm eps 1e-6).  The parameters are
    drawn from Flax's distributions with a generator seeded from ``seed``
    (other numbers than Flax's), or taken from ``params`` (npz name ->
    array).  ``dropout`` applies in training mode, its masks drawn from
    :attr:`generator` (PyTorch's default generator when None)."""

    def __init__(self, dropout=0.0, seed=0, params=None):
        super().__init__()
        self.dropout_rate = float(dropout)
        self.generator = None
        gen = torch.Generator().manual_seed(seed)
        self.params = nn.ParameterDict({
            name: nn.Parameter(
                torch.as_tensor(np.asarray(params[name]), dtype=torch.float32)
                if params is not None else _flax_init(name, shape, gen))
            for name, shape in param_shapes().items()})

    def tensors(self):
        """npz name -> parameter."""
        return dict(self.params.items())

    def forward(self, chars, dec_in):
        drop = (_Dropout(self.dropout_rate, self.generator)
                if self.training and self.dropout_rate > 0 else None)
        p = self.tensors()
        enc, cmask = encode(p, chars, drop)
        return decode(p, enc, cmask, dec_in, drop)


def _phones(tokens):
    """Decoded token ids -> phones, up to the first EOS or PAD."""
    phones = []
    for t in tokens:
        if t in (PH_EOS, PH_PAD):
            break
        if int(t) in ID_TO_PH:
            phones.append(ID_TO_PH[int(t)])
    return phones


class NeuralG2P:
    """Decoding wrapper around the trained weights: beam > 1 runs the
    fixed-width beam search, beam = 1 the greedy decoder (the JAX
    package's default is beam 4)."""

    def __init__(self, weights_path=DEFAULT_WEIGHTS, beam=4, device="cpu",
                 params=None):
        """``params``: a flat dict of tensors (:meth:`G2PModel.tensors`)
        in place of the weights file."""
        self.device = torch.device(device)
        self.params = (load_params(weights_path, self.device)
                       if params is None else
                       {k: v.detach().to(self.device, torch.float32)
                        for k, v in params.items()})
        self.beam = int(beam)

    def _greedy(self, chars):
        enc, cmask = encode(self.params, chars)
        B = chars.shape[0]
        dec = torch.zeros((B, MAX_PRON), dtype=torch.int64, device=self.device)
        dec[:, 0] = PH_BOS
        toks = []
        for t in range(MAX_PRON - 1):
            logits = decode(self.params, enc, cmask, dec)
            nxt = torch.argmax(logits[:, t], dim=-1)
            dec[:, t + 1] = nxt
            toks.append(nxt)
        return torch.stack(toks, dim=1)                     # [B, MAX_PRON-1]

    def _beam(self, chars):
        """-> (tokens [B, W, MAX_PRON - 1] of every beam, their total
        log-probs [B, W])."""
        B, W, V = chars.shape[0], self.beam, N_PHONES
        # finished beams may only extend with PAD, at no score cost
        pad_row = torch.full((V,), -1e9, device=self.device)
        pad_row[PH_PAD] = 0.0
        enc, cmask = encode(self.params, chars.repeat_interleave(W, dim=0))
        dec = torch.zeros((B, W, MAX_PRON), dtype=torch.int64,
                          device=self.device)
        dec[:, :, 0] = PH_BOS
        # only beam 0 is live at t=0 so the W initial expansions differ
        scores = torch.full((B, W), -1e9, device=self.device)
        scores[:, 0] = 0.0
        done = torch.zeros((B, W), dtype=torch.bool, device=self.device)
        for t in range(MAX_PRON - 1):
            logits = decode(self.params, enc, cmask,
                            dec.reshape(B * W, MAX_PRON))
            logp = F.log_softmax(logits[:, t].reshape(B, W, V), dim=-1)
            logp = torch.where(done[:, :, None], pad_row, logp)
            total = (scores[:, :, None] + logp).reshape(B, W * V)
            # lax.top_k order: descending, ties to the lower index
            total_sorted, order = torch.sort(total, dim=1, descending=True,
                                             stable=True)
            scores, flat_idx = total_sorted[:, :W], order[:, :W]
            src = flat_idx // V
            tok = flat_idx % V
            dec = torch.gather(dec, 1, src[:, :, None].expand(-1, -1, MAX_PRON))
            done = torch.gather(done, 1, src)
            dec[:, :, t + 1] = torch.where(done, dec[:, :, t + 1], tok)
            done = done | (tok == PH_EOS) | (tok == PH_PAD)
        return dec[:, :, 1:], scores

    def __call__(self, word):
        """word -> [phone, ...] (empty when the word has no letters)."""
        return self.batch([word])[0]

    def batch(self, words):
        enc = [encode_word(w) for w in words]
        keep = [i for i, e in enumerate(enc) if e is not None]
        out = [[] for _ in words]
        if not keep:
            return out
        chars = torch.as_tensor(np.stack([enc[i] for i in keep]),
                                device=self.device)
        with torch.inference_mode():
            if self.beam <= 1:
                toks = self._greedy(chars)
            else:
                dec, scores = self._beam(chars)
                best = torch.argmax(scores, dim=1)
                toks = dec[torch.arange(len(keep), device=self.device), best]
        toks = toks.cpu().numpy()
        for row, i in enumerate(keep):
            out[i] = _phones(toks[row])
        return out

    def beam_candidates(self, words):
        """Every beam of the beam search with its score -> (candidates
        [B][W] phone lists, scores [B, W] total log-probs, numpy); every
        word must be encodable."""
        chars = torch.as_tensor(np.stack([encode_word(w) for w in words]),
                                device=self.device)
        with torch.inference_mode():
            dec, scores = self._beam(chars)
        dec = dec.cpu().numpy()
        return ([[_phones(dec[b, w]) for w in range(dec.shape[1])]
                 for b in range(dec.shape[0])], scores.cpu().numpy())
