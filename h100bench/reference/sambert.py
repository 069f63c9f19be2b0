"""Plain PyTorch training step of SAM-BERT with MAS alignment, as KAN-TTS
trains it (``kantts/models/sambert``, ``kantts/train/loss.py``,
``sambert_16k_MAS.yaml``): float32, with TF32 off in both flags (the
harness sets them from the configuration, and turns them on only for the
control), in functional form over a dict of weights in the KAN-TTS
state-dict layout. It imports nothing of the measured program.

The forward:

- text encoder: four summed symbol embeddings times sqrt(d_model), plus
  sinusoids of positions 1.. (exponent i / (d/2 - 1), sin then cos halves),
  then FFT blocks (pre-LN multi-head self attention, a residual where the
  widths match; pre-LN conv FFN, kernels 3 and 1, residual), padding rows
  zeroed after each, a final LayerNorm and a projection without bias;
- alignment: conv key and query projections, similarity -0.0005 |q - k|^2,
  log-softmax over text plus the log beta-binomial prior, softmax over the
  valid text; the hard path by a plain Viterbi (``viterbi``); durations are
  its column sums, the mel padding stashed on the EOS slot; pitch and
  energy targets the mean of each token's nonzero frames;
- variance adaptor: pitch and energy predictors (FSMN: 1x1 FFN, depthwise
  memory filter with residual, residual between layers; then a BiLSTM over
  each item's own length, then a linear head), the pitch and energy
  embeddings (k=9 convs), the teacher-forced duration predictor (prenet of
  two ReLU layers, a 2-layer LSTM, ReLU head over log(previous target + 1));
- length regulator: durations rounded floor(d + 0.5), each token's frames
  plus sinusoids of each frame's 1-based position within its token
  (interleaved sin and cos), the emotion and speaker embeddings expanded
  alike; frames regrouped by r = 3 into the decoder memory;
- PNCA decoder: prenet over the previous group's last frame, the memory
  concatenated and projected, then per layer one pre-LN query set attending
  over the decoder's own history (keys in [t - w, t]) and over the memory
  (keys in [t, t + w]), w the largest duration over r, rounded; the two
  outputs projected and summed, residual; a 1x1 conv FFN; a LayerNorm and
  the output head;
- postnet: FSMN with the look-ahead shift 17, an LSTM and a linear head,
  added to the decoder's mels.

The losses: L1 of the decoder and postnet mels, of log(duration + 1), pitch
and energy, each over the valid elements; CTC of the frames against the
text positions over the alignment's log-probabilities (blank -1), each
item's over its text length, averaged; the binarization KL of the hard
path against the soft map, ramped in over ``warmup_epoch``. Then the
gradient by autograd, clipped to the global norm ``grad_norm``, and Adam
with the NoamLR factor of each update.

Where this departs from the description, or from a literal reading of it:

- the LSTMs are written out gate by gate (i, f, g, o; sigmoid, sigmoid,
  tanh, sigmoid; both biases added); the BiLSTM's reverse direction starts
  at each item's last valid step, and its outputs past an item's length are
  zero, as a packed sequence gives them;
- dropout takes its masks from a ``Dropout`` object: replayed from the
  masks the measured program drew (``masks``, in the order the sites run),
  or drawn here and recorded (the control). A mask of fewer items than the
  batch covers its first items and the rest draw their own;
- the hard path is not differentiated. ``step`` may be given the soft map
  to take the path from (``path_soft``): the measured program's, so that
  near-ties of a nearly flat map at random initialisation decide the path
  as they did there; everything continuous is this file's own;
- CTC runs through ATen's CPU ``F.ctc_loss`` in float64 on the host (not
  the CUDA kernel the program uses), its gradient brought back in float32;
- masked attention logits take -1e9, so that a padded query row stays
  finite, and padding rows are zeroed where the published model zeroes
  them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
NEG = -1e9  # a disallowed attention logit
NEG_PATH = -1e30  # a disallowed Viterbi score


# --------------------------------------------------------------- dropout

class Dropout:
    """Masks of the dropout sites, consumed in the order the forward runs
    them: ``masks`` a list of (mask, p) to replay, or None to draw from
    ``generator`` and record into ``drawn``."""

    def __init__(self, masks: Optional[List[Tuple[torch.Tensor, float]]] = None,
                 generator: Optional[torch.Generator] = None, active: bool = True):
        self.masks = None if masks is None else list(masks)
        self.generator, self.active = generator, active
        self.drawn: List[Tuple[torch.Tensor, float]] = []
        self.used = 0

    def _draw(self, shape, p: float, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=device) >= p

    def __call__(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if not self.active or p == 0.0:
            return x
        if self.masks is None:
            mask = self._draw(x.shape, p, x.device)
            self.drawn.append((mask, p))
        else:
            if self.used >= len(self.masks):
                raise ValueError(f"dropout site {self.used} has no recorded mask")
            mask, q = self.masks[self.used]
            if abs(q - p) > 1e-12 or tuple(mask.shape[1:]) != tuple(x.shape[1:]) \
                    or mask.shape[0] > x.shape[0]:
                raise ValueError(f"dropout site {self.used}: recorded {tuple(mask.shape)} "
                                 f"at p={q}, the forward has {tuple(x.shape)} at p={p}")
            mask = mask.to(x.device)
            if mask.shape[0] < x.shape[0]:  # the program left items out
                rest = self._draw((x.shape[0] - mask.shape[0],) + tuple(x.shape[1:]),
                                  p, x.device)
                mask = torch.cat([mask.to(rest.dtype), rest])
        self.used += 1
        return x * mask.to(x.dtype) * (1.0 / (1.0 - p))

    def finish(self) -> None:
        if self.masks is not None and self.used != len(self.masks):
            raise ValueError(f"{len(self.masks)} recorded masks, {self.used} sites ran")


# ------------------------------------------------------------- primitives

def _lin(x: torch.Tensor, w: Weights, name: str) -> torch.Tensor:
    b = w.get(f"{name}.bias")
    return F.linear(x, w[f"{name}.weight"], b)


def _conv(x: torch.Tensor, w: Weights, name: str, groups: int = 1) -> torch.Tensor:
    """'Same' conv of odd kernel over (B, T, C)."""
    weight = w[f"{name}.weight"]
    y = F.conv1d(x.transpose(1, 2), weight, w.get(f"{name}.bias"),
                 padding=(weight.shape[-1] - 1) // 2, groups=groups)
    return y.transpose(1, 2)


def _ln(x: torch.Tensor, w: Weights, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], 1e-6)


def _zero(x: torch.Tensor, pad: Optional[torch.Tensor]) -> torch.Tensor:
    """Rows of (B, T, ...) where the (B, T) ``pad`` is True set to 0."""
    return x if pad is None else x.masked_fill(pad[..., None], 0.0)


def padding(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T) True past each length."""
    return torch.arange(T, device=lengths.device)[None, :] >= lengths[:, None]


def sinusoids(T: int, d: int, device) -> torch.Tensor:
    """(T, d): position p + 1 in row p; sin in the first half, cos in the
    second, inverse timescales 10000^(i / (d/2 - 1))."""
    pos = np.arange(1, T + 1, dtype=np.float64)[:, None]
    half = d // 2
    ang = pos / np.power(10000.0, np.arange(half, dtype=np.float64) / (half - 1))[None]
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


def _heads(t: torch.Tensor, n: int) -> torch.Tensor:
    B, T, _ = t.shape
    return t.reshape(B, T, n, -1).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    B, H, T, D = t.shape
    return t.transpose(1, 2).reshape(B, T, H * D)


def _attend(q, k, v, disallowed, drop: Dropout, p: float):
    d = q.shape[-1]
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    probs = torch.softmax(logits.masked_fill(disallowed, NEG), dim=-1)
    return torch.matmul(drop(probs, p), v)


def lstm(x: torch.Tensor, w: Weights, name: str, suffix: str = "",
         reverse: bool = False, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One LSTM layer over (B, T, D) from a zero state, the gates written
    out. ``reverse`` runs from the last step down; with ``lengths`` the
    state stays zero until each item's last valid step, and the outputs
    past it are zero."""
    w_ih, w_hh = w[f"{name}.weight_ih{suffix}"], w[f"{name}.weight_hh{suffix}"]
    bias = w[f"{name}.bias_ih{suffix}"] + w[f"{name}.bias_hh{suffix}"]
    B, T, _ = x.shape
    H = w_hh.shape[1]
    pre = F.linear(x, w_ih, bias)  # (B, T, 4H): the input's share of every step
    h = x.new_zeros((B, H))
    c = x.new_zeros((B, H))
    outs: List[Optional[torch.Tensor]] = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = pre[:, t] + h @ w_hh.t()
        i, f, g, o = gates.chunk(4, dim=1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        if lengths is not None:
            valid = (t < lengths)[:, None]
            h_new = torch.where(valid, h_new, 0.0)
            c_new = torch.where(valid, c_new, 0.0)
        h, c = h_new, c_new
        outs[t] = h
    return torch.stack(outs, dim=1)


# ----------------------------------------------------------------- blocks

def self_attention(x, w: Weights, name: str, n_head: int, key_pad, drop: Dropout,
                   p_att: float, p_out: float):
    h = _ln(x, w, f"{name}.layer_norm")
    q, k, v = _lin(h, w, f"{name}.w_qkv").chunk(3, dim=-1)
    out = _attend(_heads(q, n_head), _heads(k, n_head), _heads(v, n_head),
                  key_pad[:, None, None, :], drop, p_att)
    out = drop(_lin(_merge(out), w, f"{name}.fc"), p_out)
    return out + x if out.shape[-1] == x.shape[-1] else out


def conv_ffn(x, w: Weights, name: str, pad, drop: Dropout, p_inner: float,
             p_out: float):
    h = torch.relu(_conv(_ln(x, w, f"{name}.layer_norm"), w, f"{name}.w_1"))
    h = drop(_zero(h, pad), p_inner)
    return drop(_conv(h, w, f"{name}.w_2"), p_out) + x


def encoder(ling: torch.Tensor, pad, w: Weights, c: dict, drop: Dropout):
    """-> (projected text hiddens, the alignment's keys)."""
    e = "text_encoder."
    emb = sum(w[f"{e}{n}.weight"][ling[:, :, i]]
              for i, n in enumerate(("sy_emb", "tone_emb", "syllable_flag_emb", "ws_emb")))
    d_model = c["encoder_num_units"]
    keys = emb * math.sqrt(d_model)
    h = keys + sinusoids(ling.shape[1], emb.shape[-1], ling.device)[None]
    h = drop(h, c["encoder_dropout"])
    for i in range(c["encoder_num_layers"]):
        name = f"{e}ling_enc.fft.{i}"
        h = self_attention(h, w, f"{name}.slf_attn", c["encoder_num_heads"], pad, drop,
                           c["encoder_attention_dropout"], c["encoder_dropout"])
        h = _zero(h, pad)
        h = _zero(conv_ffn(h, w, f"{name}.pos_ffn", pad, drop,
                           c["encoder_relu_dropout"], c["encoder_dropout"]), pad)
    h = _ln(h, w, f"{e}ling_enc.ln")
    return _lin(h, w, f"{e}ling_proj"), keys


def fsmn(x, w: Weights, name: str, n_layers: int, filter_size: int, shift: int,
         p: float, pad, drop: Dropout):
    """FSMN stack: per layer a 1x1 FFN (ReLU, dropout, no second bias), a
    depthwise memory filter padded round((k-1)/2) + shift on the left and
    (k-1)//2 - shift on the right, plus its input, dropout; a residual
    between layers of one width."""
    lp = int(round((filter_size - 1) / 2)) + shift
    rp = (filter_size - 1) // 2 - shift
    h = drop(x, p)
    for i in range(n_layers):
        f = drop(torch.relu(_conv(h, w, f"{name}.ffn_lst.{i}.w_1")), p)
        f = _zero(_conv(f, w, f"{name}.ffn_lst.{i}.w_2"), pad)
        dw = w[f"{name}.memory_block_lst.{i}.conv_dw.weight"]
        m = F.conv1d(F.pad(f.transpose(1, 2), (lp, rp)), dw, groups=dw.shape[0])
        m = _zero(drop(m.transpose(1, 2) + f, p), pad)
        m = drop(m, p)
        h = m + h if m.shape[-1] == h.shape[-1] else m
    return h


def nar_predictor(x, w: Weights, name: str, c: dict, pad, lengths, drop: Dropout):
    """Pitch or energy: FSMN, BiLSTM over each item's length, linear head."""
    h = fsmn(x, w, f"{name}.fsmn", c["predictor_fsmn_num_layers"],
             c["predictor_filter_size"], c["predictor_shift"], c["predictor_dropout"],
             pad, drop)
    fwd = lstm(h, w, f"{name}.blstm", "_l0", lengths=lengths)
    bwd = lstm(h, w, f"{name}.blstm", "_l0_reverse", reverse=True, lengths=lengths)
    out = _lin(torch.cat([fwd, bwd], dim=-1), w, f"{name}.fc")[..., 0]
    return out.masked_fill(pad, 0.0)


def duration_predictor(prev_log, cond, w: Weights, c: dict, pad, drop: Dropout):
    name = "variance_adaptor.duration_predictor"
    h = prev_log
    for j in range(len(c["dur_pred_prenet_units"])):
        h = drop(torch.relu(_lin(h, w, f"{name}.prenet.fcs.{3 * j}")), 0.5)
    h = torch.cat([h, cond], dim=-1)
    h = lstm(h, w, f"{name}.lstm", "_l0")
    h = lstm(h, w, f"{name}.lstm", "_l1")
    return torch.relu(_lin(h, w, f"{name}.fc")[..., 0]).masked_fill(pad, 0.0)


def regulate(x: torch.Tensor, reps: torch.Tensor, T: int, frame_pad) -> torch.Tensor:
    """(B, T_in, D) -> (B, T, D): token j's row repeated reps[:, j] times."""
    ends = torch.cumsum(reps, dim=1)
    starts = ends - reps
    t = torch.arange(T, device=x.device, dtype=reps.dtype)[None, :, None]
    owner = ((starts[:, None, :] <= t) & (t < ends[:, None, :])).to(x.dtype)
    return _zero(torch.einsum("bot,btd->bod", owner, x), frame_pad)


def frame_positions(reps: torch.Tensor, depth: int, T: int, frame_pad) -> torch.Tensor:
    """(B, T, depth): each frame's 1-based position within its token, sin on
    even channels and cos on odd, inverse timescales 10000^(2 (i//2) / depth);
    padding frames at position 0."""
    ends = torch.cumsum(reps, dim=1)
    starts = ends - reps
    t = torch.arange(T, device=reps.device, dtype=reps.dtype)[None, :, None]
    owner = ((starts[:, None, :] <= t) & (t < ends[:, None, :])).to(reps.dtype)
    pos = t[..., 0] - (owner * starts[:, None, :]).sum(-1) + 1.0
    pos = pos.masked_fill(frame_pad, 0.0)
    steps = (2 * (torch.arange(depth, device=reps.device) // 2)).double() / depth
    inv = torch.pow(10000.0, steps).float()
    ang = pos[..., None] / inv
    even = (torch.arange(depth, device=reps.device) % 2 == 0)
    return torch.where(even, torch.sin(ang), torch.cos(ang))


def token_means(frames: torch.Tensor, durs: torch.Tensor) -> torch.Tensor:
    """Mean of each token's nonzero frame values; 0 where it has none."""
    T = frames.shape[1]
    ends = torch.cumsum(durs, dim=1).clamp(max=T).long()
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], dim=1)
    tot = F.pad(torch.cumsum(frames, dim=1), (1, 0))
    cnt = F.pad(torch.cumsum((frames != 0).to(frames.dtype), dim=1), (1, 0))
    s = tot.gather(1, ends) - tot.gather(1, starts)
    n = cnt.gather(1, ends) - cnt.gather(1, starts)
    return torch.where(n == 0, 0.0, s / n.clamp(min=1.0))


def decoder(memory, targets, band: torch.Tensor, group_pad, w: Weights, c: dict,
            drop: Dropout):
    """-> (B, T / r, r * n_mels)."""
    name = "mel_decoder.mel_dec"
    r, d_model, heads = c["outputs_per_step"], c["decoder_num_units"], c["decoder_num_heads"]
    B = targets.shape[0]
    prev = torch.cat([targets.new_zeros((B, 1, targets.shape[-1])),
                      targets[:, r - 1::r]], dim=1)[:, :-1]
    h = prev
    for j in range(len(c["decoder_prenet_units"])):
        h = drop(torch.relu(_lin(h, w, f"{name}.prenet.fcs.{3 * j}")), 0.5)
    h = _lin(h, w, f"{name}.prenet.fcs.{3 * len(c['decoder_prenet_units'])}")
    h = _zero(_lin(torch.cat([memory, h], dim=-1), w, f"{name}.dec_in_proj"), group_pad)
    h = drop(h * math.sqrt(d_model), c["decoder_dropout"])
    T = h.shape[1]
    q_i = torch.arange(T, device=h.device)[:, None]
    k_i = torch.arange(T, device=h.device)[None, :]
    own = ~((k_i >= q_i - band) & (k_i <= q_i))[None] | group_pad[:, None, :]
    ahead = ~((k_i >= q_i) & (k_i <= q_i + band))[None] | group_pad[:, None, :]
    p_att, p_out = c["decoder_attention_dropout"], c["decoder_dropout"]
    for i in range(c["decoder_num_layers"]):
        a = f"{name}.pnca.{i}.pnca_attn"
        h_k, h_v = _lin(memory, w, f"{a}.w_h_kv").chunk(2, dim=-1)
        q, k, v = _lin(_ln(h, w, f"{a}.layer_norm"), w, f"{a}.w_x_qkv").chunk(3, dim=-1)
        q = _heads(q, heads)
        out_x = _attend(q, _heads(k, heads), _heads(v, heads), own[:, None], drop, p_att)
        out_h = _attend(q, _heads(h_k, heads), _heads(h_v, heads), ahead[:, None],
                        drop, p_att)
        out = _lin(_merge(out_x), w, f"{a}.fc_x") + _lin(_merge(out_h), w, f"{a}.fc_h")
        h = _zero(drop(out, p_out) + h, group_pad)
        h = _zero(conv_ffn(h, w, f"{name}.pnca.{i}.pos_ffn", group_pad, drop,
                           c["decoder_relu_dropout"], p_out), group_pad)
    return _lin(_ln(h, w, f"{name}.ln"), w, f"{name}.dec_out_proj")


def postnet(x, w: Weights, c: dict, pad, drop: Dropout):
    h = fsmn(x, w, "mel_postnet.fsmn", c["postnet_fsmn_num_layers"],
             c["postnet_filter_size"], c["postnet_shift"], c["postnet_dropout"], pad, drop)
    return _lin(lstm(h, w, "mel_postnet.lstm", "_l0"), w, "mel_postnet.fc")


def alignment(mel, keys, text_pad, prior, w: Weights):
    """-> (soft (B, 1, T_mel, T_text), log-probabilities, same shape)."""
    k = torch.relu(_conv(keys, w, "align_attention.key_proj.0.conv"))
    k = _conv(k, w, "align_attention.key_proj.2.conv")
    q = torch.relu(_conv(mel, w, "align_attention.query_proj.0.conv"))
    q = torch.relu(_conv(q, w, "align_attention.query_proj.2.conv"))
    q = _conv(q, w, "align_attention.query_proj.4.conv")
    dist = ((q * q).sum(-1)[:, :, None] + (k * k).sum(-1)[:, None, :]
            - 2.0 * torch.matmul(q, k.transpose(1, 2)))
    logp = torch.log_softmax(-0.0005 * dist, dim=-1) + torch.log(prior + 1e-8)
    soft = torch.softmax(logp.masked_fill(text_pad[:, None, :], NEG), dim=-1)
    return soft[:, None], logp[:, None]


@torch.no_grad()
def viterbi(soft: torch.Tensor, in_lens: torch.Tensor, out_lens: torch.Tensor
            ) -> torch.Tensor:
    """The monotonic path of most log-probability through (B, 1, T_mel,
    T_text), one text step at most a frame, from (0, 0) to (out_len - 1,
    in_len - 1): -> 0/1 of the same shape. Scores are log(max(p, 1e-30)) in
    float32, summed in float32; a tie between staying and coming from the
    column before comes from the column before; rows past out_len and
    columns past in_len are 0."""
    a = soft[:, 0].float()
    B, T_mel, T_text = a.shape
    dev = a.device
    in_l = in_lens.to(dev).long().clamp(0, T_text)
    out_l = out_lens.to(dev).long().clamp(0, T_mel)
    col = torch.arange(T_text, device=dev)
    score = torch.where((col[None, :] < in_l[:, None])[:, None, :],
                        torch.log(a.clamp(min=1e-30)), NEG_PATH)
    best = torch.where(col[None, :] == 0, score[:, 0], NEG_PATH)
    came_left = torch.zeros((B, T_mel, T_text), dtype=torch.bool, device=dev)
    wall = torch.full((B, 1), NEG_PATH, device=dev)
    for i in range(1, T_mel):
        left = torch.cat([wall, best[:, :-1]], dim=1)
        came_left[:, i] = left >= best
        best = score[:, i] + torch.where(came_left[:, i], left, best)
    path = torch.zeros_like(a)
    j = in_l - 1
    items = torch.arange(B, device=dev)
    for i in range(T_mel - 1, -1, -1):
        on = (i < out_l) & (j >= 0)
        jj = j.clamp(min=0)
        path[items, i, jj] = on.float()
        j = j - (came_left[items, i, jj] & on).long()
    return path[:, None]


def ctc(logp: torch.Tensor, in_lens, out_lens, blank_logprob: float = -1.0
        ) -> torch.Tensor:
    """CTC of each item's frames against its text positions 1..in_len
    (class 0 the blank, at ``blank_logprob`` before the softmax; classes past
    in_len at -1e9), over its text length, averaged over the batch: ATen's
    CPU kernel on a float64 host copy, differentiated back through it."""
    B, _, T_mel, T_text = logp.shape
    logits = F.pad(logp[:, 0], (1, 0), value=blank_logprob)
    cls = torch.arange(T_text + 1, device=logp.device)
    logits = logits.masked_fill(cls[None, None, :] > in_lens[:, None, None], NEG)
    host = torch.log_softmax(logits, dim=-1).to("cpu", torch.float64)
    targets = torch.arange(1, T_text + 1).repeat(B, 1)
    in_l, out_l = in_lens.cpu().long(), out_lens.cpu().long()
    per = F.ctc_loss(host.transpose(0, 1), targets, out_l, in_l, blank=0,
                     reduction="none", zero_infinity=True)
    return ((per / in_l.double()).sum() / B).to(logp.device, logp.dtype)


# ----------------------------------------------------------------- a step

def clip_grads(grads: Dict[str, torch.Tensor], max_norm: float
               ) -> Dict[str, torch.Tensor]:
    """Every gradient times max_norm / norm where the global norm is at
    least max_norm (autograd may hand two leaves one tensor: none is
    scaled in place)."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    return {k: g * scale for k, g in grads.items()}


def noam(count: int, warmup: int) -> float:
    step = max(count, 1)
    return warmup ** 0.5 * min(step ** -0.5, step * warmup ** -1.5)


class Adam:
    """Adam without weight decay, its rate the NoamLR factor of the update's
    count times the base rate; the count starts at ``first_update``."""

    def __init__(self, leaves: Weights, opt: dict, sched: dict, first_update: int):
        p = opt["params"]
        if p.get("weight_decay", 0.0):
            raise ValueError("the reference's Adam takes no weight decay")
        if sched["type"] != "NoamLR":
            raise ValueError(f"the reference has no {sched['type']} schedule")
        self.lr, self.betas, self.eps = p["lr"], tuple(p["betas"]), p["eps"]
        self.warmup = sched["params"]["warmup_steps"]
        self.count, self.t = first_update, 0
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}

    @torch.no_grad()
    def step(self, leaves: Weights, grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        lr = self.lr * noam(self.count, self.warmup)
        self.t += 1
        self.count += 1
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            leaves[k].sub_(lr * m_hat / (v_hat.sqrt() + self.eps))


LOSSES = ("mel_loss_", "mel_loss", "dur_loss", "pitch_loss", "energy_loss",
          "attn_ctc_loss", "attn_kl_loss")


class SambertReference:
    """SAM-BERT's weights and Adam's state, stepped as the recipe steps them.
    ``config``: the training config (``Model.KanTtsSAMBERT``, ``Loss``,
    ``grad_norm``); ``weights``: every parameter by its state-dict name,
    copied."""

    def __init__(self, config: dict, weights: Weights, first_update: int):
        part = config["Model"]["KanTtsSAMBERT"]
        self.c = part["params"]
        if not self.c.get("MAS", False) or self.c.get("FP") or self.c.get("NSF") \
                or self.c.get("SE") or self.c.get("using_byte"):
            raise ValueError("the reference is SAM-BERT with MAS alone")
        self.w = {k: v.detach().clone() for k, v in weights.items()}
        self.opt = Adam(self.w, part["optimizer"], part["scheduler"], first_update)
        self.grad_norm = config["grad_norm"]
        kl = config["Loss"]["AttentionBinarizationLoss"].get("params", {})
        self.kl_start, self.kl_warmup = kl.get("start_epoch", 0), kl.get("warmup_epoch", 100)

    def forward(self, b: Dict[str, torch.Tensor], drop: Dropout,
                path_soft: Optional[torch.Tensor] = None,
                path: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The teacher-forced forward. The hard path: ``path`` as given, else
        the Viterbi of ``path_soft`` for its items and of this forward's own
        soft map for the rest."""
        c, w = self.c, self.w
        r = c["outputs_per_step"]
        ling = b["input_lings"].long()
        in_len, out_len = b["valid_input_lengths"].long(), b["valid_output_lengths"].long()
        mel = b["mel_targets"]
        B, T_in = ling.shape[:2]
        T_mel = mel.shape[1]
        text_pad, frame_pad = padding(in_len, T_in), padding(out_len, T_mel)

        text_hid, keys = encoder(ling, text_pad, w, c, drop)
        soft, logp = alignment(mel, keys, text_pad, b["attn_priors"], w)
        if path is None:
            own = viterbi(soft, in_len, out_len)
            if path_soft is None:
                path = own
            else:
                n = path_soft.shape[0]
                path = torch.cat([viterbi(path_soft, in_len[:n], out_len[:n]), own[n:]])
        durs = path.sum(dim=2)[:, 0, :]
        pitch_t = token_means(b["pitch_contours"], durs)
        energy_t = token_means(b["energy_contours"], durs)
        stash = (T_mel - out_len).to(durs.dtype)
        durs = F.pad(durs, (0, 1)).scatter(1, in_len[:, None], stash[:, None])[:, :T_in]

        emo = w["emo_tokenizer.weight"][b["input_emotions"].long()]
        spk = w["spk_tokenizer.weight"][b["input_speakers"].long()]
        var_in = torch.cat([text_hid, spk, emo], dim=-1)
        va = "variance_adaptor"
        pitch = nar_predictor(var_in, w, f"{va}.pitch_predictor", c, text_pad, in_len, drop)
        energy = nar_predictor(var_in, w, f"{va}.energy_predictor", c, text_pad, in_len,
                               drop)
        text_aug = (text_hid + _conv(pitch_t[..., None], w, f"{va}.pitch_emb")
                    + _conv(energy_t[..., None], w, f"{va}.energy_emb"))
        cond = torch.cat([text_aug, spk, emo], dim=-1)
        prev = F.pad(durs[:, :-1], (1, 0))
        log_dur = duration_predictor(torch.log(prev + 1.0)[..., None], cond, w, c,
                                     text_pad, drop)

        reps = torch.floor(durs + 0.5)
        lr_text = (regulate(text_aug, reps, T_mel, frame_pad)
                   + frame_positions(reps, text_aug.shape[-1], T_mel, frame_pad))
        lr_emo = regulate(emo, reps, T_mel, frame_pad)
        lr_spk = regulate(spk, reps, T_mel, frame_pad)
        G = T_mel // r
        memory = torch.cat([lr_text.reshape(B, G, -1), lr_spk[:, ::r], lr_emo[:, ::r]],
                           dim=-1)
        band = torch.floor(durs.masked_fill(text_pad, 0.0).max() / r + 0.5).long()
        group_pad = padding((out_len + r - 1) // r, G)
        dec = decoder(memory, mel, band, group_pad, w, c, drop)
        dec = _zero(dec.reshape(B, T_mel, -1), frame_pad)
        post = _zero(postnet(dec, w, c, frame_pad, drop) + dec, frame_pad)
        drop.finish()
        return {"dec": dec, "post": post, "log_dur": log_dur, "pitch": pitch,
                "energy": energy, "durs": durs, "pitch_t": pitch_t,
                "energy_t": energy_t, "soft": soft, "logp": logp, "path": path}

    def losses(self, b, f, epoch: int, with_ctc: bool = True) -> Dict[str, torch.Tensor]:
        in_len, out_len = b["valid_input_lengths"].long(), b["valid_output_lengths"].long()
        mel = b["mel_targets"]
        frames = ~padding(out_len, mel.shape[1])
        n_mel = frames.sum() * mel.shape[-1]
        tokens = ~padding(in_len, f["durs"].shape[1])
        n_tok = tokens.sum()

        def l1(a, t, valid, n):
            return ((a - t).abs() * valid).sum() / n
        out = {"mel_loss_": l1(f["dec"], mel, frames[..., None], n_mel),
               "mel_loss": l1(f["post"], mel, frames[..., None], n_mel),
               "dur_loss": l1(f["log_dur"], torch.log(f["durs"] + 1.0), tokens, n_tok),
               "pitch_loss": l1(f["pitch"], f["pitch_t"], tokens, n_tok),
               "energy_loss": l1(f["energy"], f["energy_t"], tokens, n_tok)}
        out["attn_ctc_loss"] = (ctc(f["logp"], in_len, out_len) if with_ctc
                                else f["logp"].new_zeros(()))
        kl = -(torch.log(f["soft"].clamp(min=1e-12)) * f["path"]).sum() / f["path"].sum()
        ramp = (min(max((epoch - self.kl_start) / self.kl_warmup, 0.0), 1.0)
                * float(epoch >= self.kl_start))
        out["attn_kl_loss"] = kl * ramp
        return out

    def gradients(self, b: Dict[str, torch.Tensor], epoch: int, drop: Dropout,
                  path_soft: Optional[torch.Tensor] = None,
                  path: Optional[torch.Tensor] = None,
                  with_ctc: bool = True) -> Dict[str, object]:
        """The forward and backward on batch ``b`` (the collate's keys,
        tensors) -> the losses, the clipped gradients as Adam gets them, the
        path and the soft map."""
        for v in self.w.values():
            v.requires_grad_(True)
        f = self.forward(b, drop, path_soft, path)
        losses = self.losses(b, f, epoch, with_ctc)
        total = sum(losses[k] for k in LOSSES)
        names = list(self.w)
        grads = torch.autograd.grad(total, [self.w[k] for k in names], allow_unused=True)
        grads = {k: g for k, g in zip(names, grads) if g is not None}
        for v in self.w.values():
            v.requires_grad_(False)
        return {"losses": {k: v.detach() for k, v in losses.items()},
                "total": total.detach(), "grads": clip_grads(grads, self.grad_norm),
                "path": f["path"], "soft": f["soft"].detach()}

    def step(self, b: Dict[str, torch.Tensor], epoch: int, drop: Dropout,
             path_soft: Optional[torch.Tensor] = None,
             path: Optional[torch.Tensor] = None,
             with_ctc: bool = True) -> Dict[str, object]:
        """One train step: ``gradients``, then Adam."""
        out = self.gradients(b, epoch, drop, path_soft, path, with_ctc)
        self.opt.step(self.w, out["grads"])
        return out
