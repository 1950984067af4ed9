"""Plain reference of ``glm4-9b``: a GLM-4-9B-shaped dense decoder
(hf:THUDM/glm-4-9b widths), as the configuration beside this file states
it, with what the benchmark reads of its shape: the weight tree's layout,
a step's model FLOPs and the operators one forward reports.

Each of the 40 layers: RMSNorm, grouped-query attention (32 query heads,
2 KV heads, head 128) with rotary embedding over the two halves of each
head, a residual; RMSNorm, a SiLU-gated MLP of width 13696, a residual.
Then the final RMSNorm and an untied output head over 151552 ids.

Departures from the published model, as the port has them: no bias on
the Q/K/V projections, rotary over the whole head (GLM-4 rotates half of
it), norm scales applied as ``1 + scale``.
"""

from portbench import flops, reflib as R, weights


def hidden(params, tokens, cfg, prec="bf16"):
    """Last hidden state (B, S, d) of ``tokens`` (B, S) in the compute
    dtype; ``prec="fp8"`` is the control."""
    h = R.embed(params, tokens, R.torch_dtype(cfg.dtype))
    for i in range(cfg.n_layers):
        h = R.attention_block(R.layer(params["layers"], i), h, cfg, prec)
    return h


def layout(cfg) -> dict:
    """The parameter tree: the ends and ``layers`` stacked on a leading
    axis of ``n_layers``."""
    n, d = (cfg.n_layers,), cfg.d_model
    return {**weights.ends(cfg), "layers": {
        "attn": weights.attn(cfg, n), "ln1": (n + (d,), "norm", 0),
        "ln2": (n + (d,), "norm", 0), "mlp": weights.mlp(cfg, n)}}


def step_flops(cfg, batch: int, seq: int) -> int:
    """Model FLOPs of one forward over a (batch, seq) prompt batch with
    logits at every position."""
    tokens = batch * seq
    per_layer = (flops.attn_token(cfg) + flops.mlp_token(cfg)) * tokens \
        + flops.attn_sequence(cfg, seq) * batch
    return flops.head_token(cfg) * tokens + cfg.n_layers * per_layer


def operators(cfg, batch: int, seq: int) -> list:
    """The operators one forward over a (batch, seq) batch reports, in
    order, each ``(name, [bytes of each operand])``: inputs, then outputs;
    activations in the compute dtype, weights in the parameter dtype (one
    layer's slice of a stacked leaf), token ids int32."""
    act = R.torch_dtype(cfg.dtype).itemsize
    par = R.torch_dtype(cfg.param_dtype).itemsize
    t, d, f, v = batch * seq, cfg.d_model, cfg.d_ff, cfg.vocab_size
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    x = t * d * act
    layer = [
        ("attn.qkv_proj", [x, d * q * par, d * kv * par, d * kv * par,
                           t * q * act, t * kv * act, t * kv * act]),
        ("attn.sdpa", [t * q * act, t * kv * act, t * kv * act, t * q * act]),
        ("attn.out_proj", [t * q * act, q * d * par, x]),
        ("mlp.glu", [x, d * f * par, d * f * par, f * d * par,
                     t * f * act, t * f * act, x]),
    ]
    ops = [("embed.lookup", [t * 4, v * d * par, x])]
    for i in range(cfg.n_layers):
        ops += [(f"layer{i}", [x])] + layer
    return ops + [("lm_head", [x, t * v * act])]
