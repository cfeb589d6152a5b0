"""Flat-start monophone forced aligner, Viterbi / segmental K-means (port
of ``fastspeech2_tpu/align/aligner.py``).

Given utterance audio and its known phone sequence, it estimates per-phone
durations in training mel frames with no external tools or pretrained
models (the classic HTK flat-start recipe, hard-EM flavour):

1. Each tied phone type gets `n_states` left-to-right HMM states, each
   state a diagonal Gaussian over MFCC+delta features (features.py).
2. Flat start: frames are uniformly segmented across each utterance's
   state chain; Gaussians are estimated from that segmentation.
3. Iterate: batched Viterbi decode -> re-estimate Gaussians from the new
   hard alignment -> repeat until the total Viterbi log-likelihood stops
   improving.

The emissions, the Viterbi forward pass and the EM statistics run on the
device the aligner is given; the state layout, the backtrack and the
Gaussian update run on the host, as in the JAX package.  The JAX package's
``lax.scan`` over frames is a Python loop here, one batched max-plus step
per frame (``torch.max`` over a dimension takes the first of equal values,
as ``jnp.argmax`` does).  The EM statistics are one-hot products rather
than scatter-adds, so a run on the card repeats bit for bit.

Durations are exact partitions: per utterance they sum to the number of
mel frames.
"""

import dataclasses
import math
import time
from typing import List, Sequence

import numpy as np
import torch
from torch.nn import functional as F

NEG = -1.0e9          # "log zero" that stays NaN-free under arithmetic

SILENCES = ("sil", "sp", "spn", "")


def strip_stress(phone):
    """ARPAbet stress tie: IY0/IY1/IY2 share one set of Gaussians."""
    return phone.rstrip("0123456789")


@dataclasses.dataclass
class Utterance:
    """One alignment problem: features + known phone-token sequence."""

    feats: np.ndarray          # [T, D] CMVN'd features
    n_frames: int
    tokens: Sequence[str]      # phone strings, e.g. ["HH", "AH0", ...]
    optional: Sequence[bool]   # True = token may receive zero frames


@dataclasses.dataclass
class Alignment:
    durations: np.ndarray      # [n_tokens] int32 frames, sums to n_frames
    loglik: float              # Viterbi log-likelihood of the utterance


def _build_state_arrays(utts, type_of, key_of, n_states):
    """Pad per-utterance state chains to a common [B, M] layout."""
    b = len(utts)
    n_max = max(len(u.tokens) for u in utts)
    m = n_max * n_states
    state_type = np.zeros((b, m), np.int32)
    state_token = np.zeros((b, m), np.int32)
    state_skip = np.zeros((b, m), bool)
    state_valid = np.zeros((b, m), bool)
    for i, u in enumerate(utts):
        for j, tok in enumerate(u.tokens):
            for s in range(n_states):
                k = j * n_states + s
                state_type[i, k] = type_of[key_of(tok)] * n_states + s
                state_token[i, k] = j
                state_skip[i, k] = bool(u.optional[j]) or s > 0
                state_valid[i, k] = True
    return state_type, state_token, state_skip, state_valid


def _transition_masks(state_skip, state_valid):
    """[B, M, M] log-mask: 0 where i->j allowed (per frame), NEG otherwise.

    Allowed: self-loop j==i, or forward j>i with every valid state
    strictly between i and j skippable (this is what lets optional
    silences and surplus phone states take zero frames).
    """
    b, m = state_skip.shape
    mandatory = state_valid & ~state_skip
    # last_mand[j] = index of the last mandatory state < j (-1 if none)
    idx = np.arange(m)
    last_mand = np.full((b, m), -1, np.int64)
    for i in range(b):
        lm = -1
        for j in range(m):
            last_mand[i, j] = lm
            if mandatory[i, j]:
                lm = j
    i_idx = idx[None, :, None]
    j_idx = idx[None, None, :]
    # last_mand is indexed by j -> broadcast it over the i axis
    fwd = (i_idx < j_idx) & (i_idx >= last_mand[:, None, :])
    allowed = fwd | (i_idx == j_idx)
    allowed &= state_valid[:, :, None] & state_valid[:, None, :]
    trans = np.where(allowed, 0.0, NEG).astype(np.float32)

    # entry mask: states enterable at t=0 (nothing mandatory before them)
    init = state_valid & (last_mand == -1)
    # exit mask: nothing mandatory after them
    first_mand_after = np.full((b, m), m, np.int64)
    for i in range(b):
        fm = m
        for j in range(m - 1, -1, -1):
            first_mand_after[i, j] = fm
            if mandatory[i, j]:
                fm = j
    exit_ = state_valid & (first_mand_after == m)
    return trans, init, exit_


def _emissions(feats, state_type, means, variances, var_floor=0.01):
    """Diagonal-Gaussian log-likelihoods gathered per state.

    feats [B, T, D], state_type [B, M] -> [B, T, M].
    """
    var = torch.clamp(variances, min=var_floor)
    # quadratic expansion: ll = -0.5 x^2 . (1/var) + x . (mu/var) + const_k,
    # two [B,T,D]x[D,K] products instead of a [B,T,K,D] broadcast
    inv = 1.0 / var                                # [K, D]
    const = -0.5 * (means ** 2 * inv
                    + torch.log(2.0 * math.pi * var)).sum(-1)   # [K]
    ll = (-0.5 * torch.einsum("btd,kd->btk", feats ** 2, inv)
          + torch.einsum("btd,kd->btk", feats, means * inv)
          + const[None, None])
    index = state_type[:, None, :].expand(-1, ll.shape[1], -1)
    return torch.gather(ll, 2, index)              # [B, T, M]


def _viterbi_forward(emis, trans, init_mask, frame_mask):
    """Max-plus forward pass, one batched step per frame.

    emis [B, T, M], trans [B, M, M], init_mask [B, M] bool,
    frame_mask [B, T] bool.  Returns (final_scores [B, M],
    backptr [B, T, M] int32).
    """
    b, t_max, m = emis.shape
    score = torch.where(init_mask, emis[:, 0], NEG)
    backptr = torch.zeros((b, t_max, m), dtype=torch.int32,
                          device=emis.device)
    stay = torch.arange(m, dtype=torch.int32, device=emis.device)[None, :]
    for t in range(1, t_max):
        cand = score[:, :, None] + trans            # [B, M(i), M(j)]
        best, bp = cand.max(dim=1)
        new = best + emis[:, t]
        # frames past the utterance end freeze the score (self bp)
        keep = frame_mask[:, t, None]
        score = torch.where(keep, new, score)
        backptr[:, t] = torch.where(keep, bp.to(torch.int32), stay)
    return score, backptr


def _backtrack(final, backptr, exit_mask, n_frames):
    """Host-side path recovery (tiny: [T] ints per utterance)."""
    final = np.asarray(final)
    backptr = np.asarray(backptr)
    b, t_max, m = backptr.shape
    paths = np.zeros((b, t_max), np.int32)
    logliks = np.zeros((b,), np.float64)
    for i in range(b):
        t_end = int(n_frames[i]) - 1
        scores = np.where(exit_mask[i], final[i], NEG)
        j = int(scores.argmax())
        logliks[i] = scores[j]
        paths[i, t_end] = j
        for t in range(t_end, 0, -1):
            j = int(backptr[i, t, j])
            paths[i, t - 1] = j
    return paths, logliks


def _accumulate(feats, paths, state_type, frame_mask, n_gauss):
    """Hard-EM sufficient statistics per tied Gaussian, as one-hot
    products (a fixed order of sums)."""
    b, t_max, d = feats.shape
    gauss_id = torch.gather(state_type, 1, paths)              # [B, T]
    gauss_id = torch.where(frame_mask, gauss_id, n_gauss)      # pad bucket
    onehot = F.one_hot(gauss_id.reshape(-1), n_gauss + 1).to(feats.dtype)
    flat_x = feats.reshape(-1, d)
    counts = onehot.sum(dim=0)
    sums = onehot.T @ flat_x
    sqsums = onehot.T @ flat_x ** 2
    return counts[:n_gauss], sums[:n_gauss], sqsums[:n_gauss]


def _update_gaussians(counts, sums, sqsums, var_floor):
    counts = np.asarray(counts)[:, None]
    sums, sqsums = np.asarray(sums), np.asarray(sqsums)
    seen = counts > 0
    means = np.where(seen, sums / np.maximum(counts, 1), 0.0)
    variances = np.where(
        seen, sqsums / np.maximum(counts, 1) - means ** 2, 1.0)
    return (means.astype(np.float32),
            np.maximum(variances, var_floor).astype(np.float32))


def _flat_start_paths(state_valid, n_frames):
    """Uniform frame->state segmentation for initialization."""
    b, m = state_valid.shape
    t_max = int(n_frames.max())
    paths = np.zeros((b, t_max), np.int32)
    for i in range(b):
        valid_idx = np.nonzero(state_valid[i])[0]
        t = int(n_frames[i])
        pos = np.minimum(
            (np.arange(t) * len(valid_idx)) // max(t, 1),
            len(valid_idx) - 1)
        paths[i, :t] = valid_idx[pos]
    return paths


class ForcedAligner:
    """Corpus-level flat-start aligner on ``device``.

    >>> aligner = ForcedAligner(n_states=3, device="cuda")
    >>> results = aligner.align(utterances)   # list[Alignment]
    """

    def __init__(self, n_states=3, n_iters=10, var_floor=0.01,
                 tie_stress=True, tol=1e-3, device="cuda"):
        self.n_states = n_states
        self.n_iters = n_iters
        self.var_floor = var_floor
        self.tie_stress = tie_stress
        self.tol = tol
        self.device = torch.device(device)
        self.key_of = (strip_stress if tie_stress else (lambda p: p))
        self.type_of = None          # tied-phone-type -> index, after fit
        self.means = None            # [n_gauss, D], after fit
        self.variances = None

    # -- shared batch packing ------------------------------------------

    def _pack(self, utts):
        state_type, state_token, state_skip, state_valid = (
            _build_state_arrays(utts, self.type_of, self.key_of,
                                self.n_states))
        trans, init_mask, exit_mask = _transition_masks(
            state_skip, state_valid)
        n_frames = np.asarray([u.n_frames for u in utts], np.int32)
        t_max = int(n_frames.max())
        d = utts[0].feats.shape[-1]
        feats = np.zeros((len(utts), t_max, d), np.float32)
        for i, u in enumerate(utts):
            feats[i, : u.n_frames] = u.feats[: u.n_frames]
        frame_mask = np.arange(t_max)[None, :] < n_frames[:, None]
        put = lambda a: torch.as_tensor(a, device=self.device)  # noqa
        return (put(feats), put(state_type.astype(np.int64)), state_token,
                state_valid, put(trans), put(init_mask), exit_mask,
                put(frame_mask), n_frames)

    def _decode(self, feats_d, state_type_d, trans_d, init_d, exit_mask,
                mask_d, n_frames):
        emis = _emissions(feats_d, state_type_d,
                          torch.as_tensor(self.means, device=self.device),
                          torch.as_tensor(self.variances,
                                          device=self.device),
                          var_floor=self.var_floor)
        final, backptr = _viterbi_forward(emis, trans_d, init_d, mask_d)
        return _backtrack(final.cpu().numpy(), backptr.cpu().numpy(),
                          exit_mask, n_frames)

    # -- EM model fitting ----------------------------------------------

    def fit(self, utts: List[Utterance], phone_inventory=None,
            verbose=False):
        """Flat-start hard-EM on `utts`; stores the Gaussians.

        phone_inventory optionally predefines the tied-type table (so a
        model fitted on a corpus sample can later `transform` batches
        containing types absent from the sample — those keep the broad
        default Gaussian).  Returns the alignments of the fitted batch.
        """
        types = {self.key_of(t) for u in utts for t in u.tokens}
        if phone_inventory is not None:
            types |= {self.key_of(t) for t in phone_inventory}
        self.type_of = {p: i for i, p in enumerate(sorted(types))}
        n_gauss = len(self.type_of) * self.n_states

        (feats_d, state_type_d, state_token, state_valid, trans_d,
         init_d, exit_mask, mask_d, n_frames) = self._pack(utts)

        paths = _flat_start_paths(state_valid, n_frames)
        last_ll = -np.inf
        logliks = np.zeros(len(utts))
        for it in range(self.n_iters):
            t0 = time.perf_counter()
            counts, sums, sqsums = _accumulate(
                feats_d, torch.as_tensor(paths, device=self.device).long(),
                state_type_d, mask_d, n_gauss)
            self.means, self.variances = _update_gaussians(
                counts.cpu().numpy(), sums.cpu().numpy(),
                sqsums.cpu().numpy(), self.var_floor)
            paths, logliks = self._decode(
                feats_d, state_type_d, trans_d, init_d, exit_mask, mask_d,
                n_frames)
            total = float(logliks.sum())
            if verbose:
                print(f"[align] iter {it}: loglik {total:.1f} "
                      f"({(time.perf_counter() - t0) * 1e3:.2f} ms)")
            if total - last_ll < self.tol * max(abs(total), 1.0) and it > 1:
                break
            last_ll = total

        return self._paths_to_alignments(
            utts, paths, state_token, n_frames, logliks)

    def transform(self, utts: List[Utterance]):
        """Viterbi-align a batch with the already-fitted Gaussians."""
        if self.means is None:
            raise RuntimeError("call fit() before transform()")
        missing = {self.key_of(t) for u in utts for t in u.tokens} \
            - set(self.type_of)
        if missing:
            raise KeyError(
                f"phone types absent from the fitted model: {missing} "
                "(pass phone_inventory= to fit())")
        (feats_d, state_type_d, state_token, _, trans_d, init_d,
         exit_mask, mask_d, n_frames) = self._pack(utts)
        paths, logliks = self._decode(
            feats_d, state_type_d, trans_d, init_d, exit_mask, mask_d,
            n_frames)
        return self._paths_to_alignments(
            utts, paths, state_token, n_frames, logliks)

    def align(self, utts: List[Utterance], verbose=False):
        """One-shot fit+align (small-corpus convenience)."""
        return self.fit(utts, verbose=verbose)

    def _paths_to_alignments(self, utts, paths, state_token, n_frames,
                             logliks):
        out = []
        for i, u in enumerate(utts):
            tok_of_frame = state_token[i][paths[i, : n_frames[i]]]
            durations = np.bincount(
                tok_of_frame, minlength=len(u.tokens)).astype(np.int32)
            assert durations.sum() == u.n_frames
            out.append(Alignment(durations=durations,
                                 loglik=float(logliks[i])))
        return out
