"""HF checkpoint import in the PyTorch port against the JAX package, on the CPU.

For every ``model_type`` the JAX loader supports, ``transformers`` writes a
tiny random checkpoint (the fixtures of ``tests/unit/test_hf_archs.py``,
plus megatron_gpt and clip_text_model built here the way that file builds
them), and:

  * the port's ``config_from_hf`` equals JAX's field for field;
  * the port's params equal JAX ``load_hf_model``'s exactly: fp32 leaf for
    leaf, and bf16 bit for bit;
  * the port's forward logits (hidden states for CLIP's text tower) are
    within 1e-4 of the HF model's, and for five architectures (mistral
    with a window, falcon, gpt2, mixtral, bert) within 1e-4 of JAX's
    ``forward`` (run at "highest" matmul precision: XLA's CPU default
    rounds fp32 products);

and the port's own safetensors reader and writer agree with the
``safetensors`` package, the ``.bin`` fallback loads, and the engine
factory dispatches and refuses as JAX's does.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from deepspeed_tpu.inference.v2 import engine_factory as jfactory  # noqa: E402
from deepspeed_tpu.models import hf as jhf  # noqa: E402
from deepspeed_tpu.models import transformer as JT  # noqa: E402
from deepspeed_tpu_torch.inference.v2 import engine_factory as pfactory  # noqa: E402
from deepspeed_tpu_torch.models import hf as phf  # noqa: E402
from deepspeed_tpu_torch.models import safetensors_io as sio  # noqa: E402
from deepspeed_tpu_torch.models import transformer as PT  # noqa: E402
from tests.unit.test_hf_archs import (  # noqa: E402,F401  (module-scoped fixtures)
    _FIXTURES,
    _save_tiny,
    tiny_bert,
    tiny_bloom,
    tiny_bloom_7heads,
    tiny_distilbert,
    tiny_falcon,
    tiny_falcon40b_style,
    tiny_falcon_mha,
    tiny_gemma,
    tiny_gpt2,
    tiny_gpt_neo,
    tiny_gptj,
    tiny_gptneox,
    tiny_gptneox_seq,
    tiny_internlm,
    tiny_linear_rope,
    tiny_llama3_rope,
    tiny_llama_bias,
    tiny_mistral_headdim,
    tiny_mistral_window,
    tiny_mixtral,
    tiny_opt,
    tiny_phi,
    tiny_phi3,
    tiny_phi3_longrope,
    tiny_qwen2,
    tiny_qwen2_moe,
    tiny_qwen3,
    tiny_qwen3_moe,
    tiny_stablelm,
    tiny_stablelm_parallel,
    tiny_starcoder2,
    tiny_yarn_rope,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp32 logits of the same function summed in another order
LOGIT_ATOL = 1e-4

ARCHS = dict(_FIXTURES, llama3_rope="tiny_llama3_rope", linear_rope="tiny_linear_rope",
             yarn_rope="tiny_yarn_rope", phi3_longrope="tiny_phi3_longrope",
             megatron_gpt="tiny_megatron_gpt", clip_text="tiny_clip_text")
# scaled RoPE bites beyond the original pretraining length (32/64 tokens)
LONG = {"llama3_rope", "linear_rope", "yarn_rope", "phi3_longrope"}
JAX_FORWARD = ("mistral_window", "falcon", "gpt2", "mixtral", "bert")


@pytest.fixture(scope="module")
def tiny_megatron_gpt(tmp_path_factory, tiny_gpt2):
    """A tiny GPT-2's weights in the Megatron-LM layout (per-head interleaved
    fused qkv, ``torch.save``), as ``test_megatron_gpt_parity`` builds them."""
    hf_model, _ = tiny_gpt2
    sd = hf_model.state_dict()
    h, nh = hf_model.config.n_embd, hf_model.config.n_head
    d = h // nh

    def per_head(parts, tail):
        return torch.stack([x.reshape(nh, d, *tail) for x in parts], dim=1)

    meg = {
        "word_embeddings.weight": sd["transformer.wte.weight"],
        "position_embeddings.weight": sd["transformer.wpe.weight"],
        "transformer.final_layernorm.weight": sd["transformer.ln_f.weight"],
        "transformer.final_layernorm.bias": sd["transformer.ln_f.bias"],
    }
    for i in range(hf_model.config.n_layer):
        g, p = f"transformer.h.{i}", f"transformer.layers.{i}"
        w, b = sd[f"{g}.attn.c_attn.weight"], sd[f"{g}.attn.c_attn.bias"]
        meg[f"{p}.attention.query_key_value.weight"] = per_head(
            [w[:, j * h:(j + 1) * h].T for j in range(3)], (h,)).reshape(3 * h, h)
        meg[f"{p}.attention.query_key_value.bias"] = per_head(
            [b[j * h:(j + 1) * h] for j in range(3)], ()).reshape(-1)
        for name, src in (("input_layernorm", "ln_1"), ("post_attention_layernorm", "ln_2")):
            meg[f"{p}.{name}.weight"] = sd[f"{g}.{src}.weight"]
            meg[f"{p}.{name}.bias"] = sd[f"{g}.{src}.bias"]
        for name, src in (("attention.dense", "attn.c_proj"), ("mlp.dense_h_to_4h", "mlp.c_fc"),
                          ("mlp.dense_4h_to_h", "mlp.c_proj")):
            meg[f"{p}.{name}.weight"] = sd[f"{g}.{src}.weight"].T.contiguous()
            meg[f"{p}.{name}.bias"] = sd[f"{g}.{src}.bias"]
    path = tmp_path_factory.mktemp("hf_megatron_gpt")
    torch.save(meg, path / "pytorch_model.bin")
    (path / "config.json").write_text(json.dumps({
        "model_type": "megatron_gpt", "vocab_size": hf_model.config.vocab_size,
        "hidden_size": h, "num_layers": hf_model.config.n_layer, "num_attention_heads": nh,
        "max_position_embeddings": hf_model.config.n_positions,
        "activation_function": "gelu_new",
    }))
    return hf_model, str(path)


@pytest.fixture(scope="module")
def tiny_clip_text(tmp_path_factory):
    torch.manual_seed(0)
    m = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=77)).eval()
    path = str(tmp_path_factory.mktemp("hf_clip_text"))
    m.save_pretrained(path)
    return m, path


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _jax_leaves(tree):
    return {tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _tokens(arch, seed=0):
    s = 96 if arch in LONG else 16
    return np.random.default_rng(seed).integers(0, 256, size=(2, s)).astype(np.int32)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_matches_jax(arch, request):
    _, path = request.getfixturevalue(ARCHS[arch])
    with open(f"{path}/config.json") as f:
        hf_cfg = json.load(f)
    assert _fields(phf.config_from_hf(hf_cfg)) == _fields(jhf.config_from_hf(hf_cfg))
    # an HF config object reads like the dict (no transformers import in the port)
    if arch != "megatron_gpt":
        obj = request.getfixturevalue(ARCHS[arch])[0].config
        assert _fields(phf.config_from_hf(obj)) == _fields(jhf.config_from_hf(obj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_match_jax(arch, dtype, request):
    """Every leaf equal to JAX's loader's, bf16 by its bits; the configs the
    loaders return (mlm_head, tied embeddings decided from the weights)
    equal too."""
    _, path = request.getfixturevalue(ARCHS[arch])
    jc, jp = jhf.load_hf_model(path, dtype=dtype)
    pc, pp = phf.load_hf_model(path, dtype=dtype, device="cpu")
    assert _fields(pc) == _fields(jc)
    want, got = _jax_leaves(jp), _port_leaves(pp)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        t = got[key]
        assert t.is_contiguous() and tuple(t.shape) == w.shape, key
        if dtype == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          w.view(np.uint16), err_msg=str(key))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), w, err_msg=str(key))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logits_match_hf(arch, request):
    hf_model, path = request.getfixturevalue(ARCHS[arch])
    cfg, params = phf.load_hf_model(path, dtype="float32", device="cpu")
    toks = _tokens(arch)
    with torch.no_grad():
        out = hf_model(torch.tensor(toks, dtype=torch.long))
        if arch == "clip_text":
            ref = out.last_hidden_state
            got, _ = PT.forward_hidden(params, torch.tensor(toks), cfg)
        else:
            ref = out.logits
            got, _ = PT.forward(params, torch.tensor(toks), cfg)
    torch.testing.assert_close(got, ref, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch", JAX_FORWARD)
def test_logits_match_jax_forward(arch, request):
    _, path = request.getfixturevalue(ARCHS[arch])
    jc, jp = jhf.load_hf_model(path, dtype="float32")
    cfg, params = phf.load_hf_model(path, dtype="float32", device="cpu")
    toks = _tokens(arch, seed=1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JT.forward(jp, jnp.asarray(toks), jc)[0], np.float32)
    with torch.no_grad():
        got = PT.forward(params, torch.tensor(toks), cfg)[0].numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the safetensors module
# ---------------------------------------------------------------------------
def _sample_tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "w32": torch.randn(5, 3, generator=g),
        "wbf16": torch.randn(4, 6, generator=g).bfloat16(),
        "w16": torch.randn(7, generator=g).half(),
        "i64": torch.arange(5, dtype=torch.int64),
        "i32": torch.arange(3, dtype=torch.int32) - 1,
        "i8": torch.tensor([-3, 0, 7], dtype=torch.int8),
        "u8": torch.arange(9, dtype=torch.uint8),
        "mask": torch.tensor([True, False, True]),
        "empty": torch.zeros(0, 4),
    }


def test_reader_equals_safetensors_on_single_and_sharded_files(tmp_path, tiny_qwen2):
    from safetensors import safe_open
    from safetensors.torch import save_file

    ts = _sample_tensors()
    save_file(ts, str(tmp_path / "one.safetensors"))
    got = sio.load_file(str(tmp_path / "one.safetensors"))
    with safe_open(str(tmp_path / "one.safetensors"), framework="pt") as f:
        assert sorted(f.keys()) == sorted(got)
        for k in f.keys():
            w = f.get_tensor(k)
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    # transformers' own sharded writer: the index and its shards
    hf_model, _ = tiny_qwen2
    shard_dir = tmp_path / "sharded"
    hf_model.save_pretrained(str(shard_dir), max_shard_size="40KB")
    assert (shard_dir / sio.INDEX).is_file()
    got = sio.load_state_dict(str(shard_dir))
    want = {}
    for name in sio.checkpoint_files(str(shard_dir)):
        with safe_open(name, framework="pt") as f:
            want.update({k: f.get_tensor(k) for k in f.keys()})
    assert len(sio.checkpoint_files(str(shard_dir))) > 1 and sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_bf16_stays_bf16_through_the_reader(tmp_path):
    from safetensors.torch import save_file

    x = (torch.randn(64, 32) * 3).bfloat16()
    save_file({"x": x}, str(tmp_path / "b.safetensors"))
    got = sio.load_file(str(tmp_path / "b.safetensors"))["x"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), x.view(torch.int16))


def test_writer_files_load_in_safetensors(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file

    ts = _sample_tensors()
    sio.save_file(ts, str(tmp_path / "mine.safetensors"), metadata={"format": "pt"})
    back = load_file(str(tmp_path / "mine.safetensors"))
    assert sorted(back) == sorted(ts)
    for k in ts:
        assert back[k].dtype == ts[k].dtype and torch.equal(back[k], ts[k]), k
    files = sio.save_sharded(ts, str(tmp_path / "dir"), shards=3)
    assert len(files) == 3
    index = json.loads((tmp_path / "dir" / sio.INDEX).read_text())
    seen = {}
    for name in files:
        with safe_open(name, framework="pt") as f:
            seen.update({k: f.get_tensor(k) for k in f.keys()})
    assert sorted(seen) == sorted(index["weight_map"]) == sorted(ts)
    for k in ts:
        assert torch.equal(seen[k], ts[k]), k


def test_pytorch_model_bin_loads(tmp_path, tiny_gpt2):
    hf_model, path = tiny_gpt2
    sd = {k: v.clone() for k, v in hf_model.state_dict().items()}
    torch.save(sd, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text((Path(path) / "config.json")
                                          .read_text())
    got = sio.load_state_dict(str(tmp_path))
    assert sorted(got) == sorted(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k
    pc, pp = phf.load_hf_model(str(tmp_path), dtype="float32", device="cpu")
    jc, jp = jhf.load_hf_model(str(tmp_path), dtype="float32")
    for key, w in _jax_leaves(jp).items():
        np.testing.assert_array_equal(_port_leaves(pp)[key].numpy(), w)


# ---------------------------------------------------------------------------
# the engine factory
# ---------------------------------------------------------------------------
def test_engine_factory_dispatch(tiny_qwen2):
    _, path = tiny_qwen2
    with open(f"{path}/config.json") as f:
        assert json.load(f)["architectures"][0] == "Qwen2ForCausalLM"
    jc, jp = jfactory.load_model_implementation(path, dtype="float32")
    pc, pp = pfactory.load_model_implementation(path, dtype="float32", device="cpu")
    assert pc.attn_qkv_bias and tuple(pp["layers"]["wq_b"].shape) == (2, 64)
    assert _fields(pc) == _fields(jc)
    jfactory._register_builtins()
    pfactory._register_builtins()
    assert sorted(pfactory.POLICY_REGISTRY) == sorted(jfactory.POLICY_REGISTRY)
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2

    v2 = pfactory.build_hf_engine(path, {"dtype": "float32"}, device="cpu")
    assert isinstance(v2, InferenceEngineV2) and v2.device.type == "cpu"
    v1 = pfactory.build_engine_v1(path, {"dtype": "float32"}, device="cpu")
    assert isinstance(v1, InferenceEngine) and v1.device.type == "cpu"


def test_unsupported_arch_raises(tmp_path):
    (tmp_path / "config.json").write_text(
        json.dumps({"model_type": "mamba", "architectures": ["MambaForCausalLM"]}))
    for load in (jhf.load_hf_model, lambda p: phf.load_hf_model(p, device="cpu")):
        with pytest.raises(ValueError, match="model_type"):
            load(str(tmp_path))
    for load in (jfactory.load_model_implementation,
                 lambda p: pfactory.load_model_implementation(p, device="cpu")):
        with pytest.raises(ValueError, match="no model implementation for architecture"):
            load(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="config.json"):
        phf.load_hf_model(str(tmp_path / "absent"), device="cpu")


def test_registered_loader_takes_the_device(tmp_path, tiny_qwen2):
    calls = []

    @pfactory.register_model_implementation("TinyTestForCausalLM")
    def loader(path, dtype, device):
        calls.append((dtype, device))
        return phf.load_hf_model(path, dtype=dtype, device=device)

    try:
        _, path = tiny_qwen2
        cfg = json.loads((Path(path) / "config.json").read_text())
        cfg["architectures"] = ["TinyTestForCausalLM"]
        for f in Path(path).iterdir():
            (tmp_path / f.name).write_bytes(f.read_bytes())
        (tmp_path / "config.json").write_text(json.dumps(cfg))
        pfactory.load_model_implementation(str(tmp_path), dtype="float32", device="cpu")
        assert calls == [("float32", "cpu")]
    finally:
        pfactory.POLICY_REGISTRY.pop("TinyTestForCausalLM", None)
