"""One LLaMA decoder layer and one ERNIE encoder layer written only with
a package's Tensors and `_C_ops`, the same code for either package
(``api`` is paddle_tpu or paddle_tpu_torch). Parameters are a dict of
Tensors under the names of the port's `models.llama.LlamaBlock` /
`models.ernie.ErnieBlock` (`named_parameters()`), so the layers can be
held against those modules on the same weights.

Importable without jax: `tests/test_torch_framework.py` holds the two
packages' layers against each other on the CPU, `chip_smoke.py` runs the
port's at full width on the card against the models.
"""


def llama_layer(api, x, p, cos, sin, n_heads, eps):
    """Pre-norm block: RMSNorm, q/k/v, rotate-half RoPE, causal SDPA,
    o_proj and residual; RMSNorm, SwiGLU MLP and residual (MHA)."""
    c = api._C_ops
    b, s, h = x.shape
    d = h // n_heads

    def heads(name, t):
        return c.reshape(c.linear(t, p[f"self_attn.{name}.weight"]),
                         [b, s, n_heads, d])

    t = c.rms_norm(x, p["input_layernorm.weight"], epsilon=eps)
    q, k = c.rotary_embedding(heads("q_proj", t), heads("k_proj", t), cos,
                              sin)
    a = c.scaled_dot_product_attention(q, k, heads("v_proj", t),
                                       is_causal=True)
    x = x + c.linear(c.reshape(a, [b, s, h]), p["self_attn.o_proj.weight"])
    t = c.rms_norm(x, p["post_attention_layernorm.weight"], epsilon=eps)
    f = c.swiglu(c.linear(t, p["mlp.gate_proj.weight"]),
                 c.linear(t, p["mlp.up_proj.weight"]))
    return x + c.linear(f, p["mlp.down_proj.weight"])


def ernie_layer(api, x, p, mask, n_heads, eps):
    """Post-LN block: fused QKV, SDPA under the additive key mask
    ``mask`` [b, 1, 1, s], out projection, residual and LayerNorm; the
    GELU (tanh) MLP, residual and LayerNorm."""
    c = api._C_ops
    b, s, h = x.shape
    qkv = c.reshape(c.linear(x, p["attn.qkv.weight"], p["attn.qkv.bias"]),
                    [b, s, 3, n_heads, h // n_heads])
    q, k, v = c.unbind(qkv, axis=2)
    a = c.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    a = c.linear(c.reshape(a, [b, s, h]), p["attn.out.weight"],
                 p["attn.out.bias"])
    x = c.layer_norm(x + a, p["ln1.weight"], p["ln1.bias"], epsilon=eps)
    f = c.linear(c.gelu(c.linear(x, p["fc1.weight"], p["fc1.bias"]),
                        approximate=True), p["fc2.weight"], p["fc2.bias"])
    return c.layer_norm(x + f, p["ln2.weight"], p["ln2.bias"], epsilon=eps)
