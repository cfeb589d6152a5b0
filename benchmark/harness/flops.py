"""The yardstick's counts: model FLOPs from an utterance's own lengths,
and kernels' least times on one H100 from their shapes.

FLOPs count a multiply-add as two operations.  A kernel's least time is
max(operations / the tensor-core peak of its data's dtype, bytes / HBM
bandwidth), each operation counted once, whatever passes an
implementation makes (the port's float32 kernels make three TF32
products for each float32 one; their shares here read a third of a
3xTF32 share); bytes count each input read once and each output written
once.  Counts are at the real lengths: an utterance's own phones and
frames, not the padding of its batch.  Peaks: NVIDIA H100 SXM data
sheet, dense, at 700 W.
"""

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}   # TF32, BF16
HBM_BYTES_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def _conv(L, c_in, c_out, k):
    return 2.0 * L * c_in * c_out * k


def _fft_block(L, d, heads, ffn, k1, k2):
    proj = 4 * 2.0 * L * d * d                  # q, k, v, fc
    attn = 2 * 2.0 * L * L * d                  # Q K^T and P V, all heads
    return proj + attn + _conv(L, d, ffn, k1) + _conv(L, ffn, d, k2)


def acoustic_flops(P, T, cfg):
    """One FastSpeech 2 forward on P phones and T frames."""
    d, f = cfg["encoder_hidden"], cfg["conv_filter_size"]
    k1, k2 = cfg["conv_kernel_size"]
    enc = cfg["encoder_layer"] * _fft_block(P, d, cfg["encoder_head"], f,
                                            k1, k2)
    vf, vk = cfg["vp_filter_size"], cfg["vp_kernel_size"]
    var = 3 * (_conv(P, d, vf, vk) + _conv(P, vf, vf, vk) + 2.0 * P * vf)
    dd = cfg["decoder_hidden"]
    dec = cfg["decoder_layer"] * _fft_block(T, dd, cfg["decoder_head"], f,
                                            k1, k2)
    n_mels = cfg["n_mel_channels"]
    mel = 2.0 * T * dd * n_mels
    e, k, n = (cfg["postnet_embedding_dim"], cfg["postnet_kernel_size"],
               cfg["postnet_n_convolutions"])
    post = _conv(T, n_mels, e, k) + (n - 2) * _conv(T, e, e, k) \
        + _conv(T, e, n_mels, k)
    return enc + var + dec + mel + post


def vocoder_flops(T, vcfg, n_mels):
    """One iSTFT HiFi-GAN forward on T frames."""
    c = vcfg["upsample_initial_channel"]
    total = _conv(T, n_mels, c, 7)
    L = T
    for u, k in zip(vcfg["upsample_rates"], vcfg["upsample_kernel_sizes"]):
        total += 2.0 * L * c * (c // 2) * k     # transposed conv
        c //= 2
        L *= u
        for rk, dils in zip(vcfg["resblock_kernel_sizes"],
                            vcfg["resblock_dilation_sizes"]):
            total += len(dils) * 2 * _conv(L, c, c, rk)
    n_fft = vcfg["gen_istft_n_fft"]
    nb = n_fft // 2 + 1
    total += _conv(L, c, 2 * nb, 7) + 2 * 2.0 * L * nb * n_fft
    return total


def _bound_s(flops, nbytes, dtype):
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S)


def resblock_ops_bytes(positions, C, k, units=3, dtype="float32"):
    """K4, one MRF ResBlock (``units`` dilation units of two k-tap
    convolutions) over ``positions`` (rows x length) of C channels ->
    (operations, bytes: the input and output once, the weights once)."""
    flops = units * 2 * (2.0 * k * C * C) * positions
    nbytes = ITEMSIZE[dtype] * (2 * positions * C
                                + units * 2 * (k * C * C + C))
    return flops, nbytes


def vocoder_k4_bound_s(frames, vcfg, dtype="float32"):
    """K4's least time over one vocoder dispatch whose rows have the given
    real frame counts."""
    total, c, n = 0.0, vcfg["upsample_initial_channel"], float(sum(frames))
    for u in vcfg["upsample_rates"]:
        c //= 2
        n *= u
        for rk, dils in zip(vcfg["resblock_kernel_sizes"],
                            vcfg["resblock_dilation_sizes"]):
            total += _bound_s(*resblock_ops_bytes(n, c, rk, len(dils),
                                                  dtype), dtype)
    return total


def attention_ops_bytes(lengths, H, D, backward=False, dtype="float32"):
    """K1 (forward) or K3 (``backward``) over rows of the given real
    lengths, H heads of D -> (operations, bytes): two L x L x D products a
    head forward, five backward; q, k, v, out (and the incoming gradient,
    dq, dk, dv) and the key mask, each once."""
    sq = float(sum(int(L) ** 2 for L in lengths))
    lin = float(sum(int(L) for L in lengths))
    flops = (5 if backward else 2) * 2.0 * H * sq * D
    nbytes = ITEMSIZE[dtype] * (7 if backward else 4) * H * lin * D + lin
    return flops, nbytes


def train_attention_bound_s(src_lens, mel_lens, cfg, dtype):
    """K1 and K3 over one training step whose rows have the given real
    phone and frame counts: every encoder and decoder block's forward and
    backward."""
    total = 0.0
    for n, lens, H, d in (
            (cfg["encoder_layer"], src_lens, cfg["encoder_head"],
             cfg["encoder_hidden"]),
            (cfg["decoder_layer"],
             [min(int(t), cfg["max_seq_len"]) for t in mel_lens],
             cfg["decoder_head"], cfg["decoder_hidden"])):
        for backward in (False, True):
            total += n * _bound_s(*attention_ops_bytes(
                lens, H, d // H, backward, dtype), dtype)
    return total
