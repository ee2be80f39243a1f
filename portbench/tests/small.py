"""Small stand-ins of the benchmark's files for the CPU tests: each
configuration family at its SMOKE widths, and a short closed-loop mix."""
import copy

DENSE = {
    "name": "qwen2-smoke", "reference": "dense",
    "port": {"name": "qwen2-smoke", "family": "dense", "n_layers": 2,
             "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
             "vocab_size": 256, "qkv_bias": True, "tie_embeddings": False,
             "norm_eps": 1e-6, "rope_theta": 1000000.0,
             "attention_impl": "pallas", "kernel_plan": "direct",
             "dtype": "float32"},
    "serve": {"cache_dtype": "float32"},
    "kernels": ["flash", "decode_attn"],
}

# the dense family's other options (Qwen3's): q/k norms, a tied head
DENSE_QK_NORM = {
    "name": "qwen3-smoke", "reference": "dense",
    "port": {"name": "qwen3-smoke", "family": "dense", "n_layers": 2,
             "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
             "vocab_size": 256, "head_dim": 32, "qk_norm": True,
             "tie_embeddings": True, "norm_eps": 1e-6,
             "rope_theta": 1000000.0, "attention_impl": "pallas",
             "kernel_plan": "direct", "dtype": "float32"},
    "serve": {"cache_dtype": "float32"},
    "kernels": ["flash", "decode_attn"],
}

SSM = {
    "name": "mamba2-smoke", "reference": "ssm",
    "port": {"name": "mamba2-smoke", "family": "ssm", "n_layers": 2,
             "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 0,
             "vocab_size": 256, "tie_embeddings": True, "norm_eps": 1e-5,
             "ssm": {"state_dim": 16, "head_dim": 32, "n_groups": 1,
                     "chunk": 8, "conv_width": 4, "expand": 2},
             "attention_impl": "pallas", "ssm_impl": "pallas",
             "kernel_plan": "direct", "dtype": "float32"},
    "serve": {"cache_dtype": "float32"},
    "kernels": ["ssd_scan", "ssd_decode"],
}

# each family's cell, whose limits the tiny cells are held to
CELL = {"dense": "qwen2-7b.code", "ssm": "mamba2-1.3b.code"}

MIX = {
    "name": "tiny", "clients": 4, "slots": 4, "max_len": 64,
    "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.5, "min": 4,
               "max": 40},
    "output": {"dist": "uniform", "min": 4, "max": 12},
    "ramp_steps": 2,
    "sample": {"requests": 16, "tokens": 200},
}


def files(config, *, dtype="float32", compare=None, mix=None):
    conf = copy.deepcopy(config)
    conf["port"]["dtype"] = dtype
    return {"cell": {"name": "tiny", "chips": 1},
            "config": conf, "mix": copy.deepcopy(mix or MIX),
            "limits": {"compare": compare or {"max_gap": 1e9}}}
