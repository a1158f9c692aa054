"""PyTorch port: tensor and data parallelism on ``torch.distributed``
against the JAX package on the CPU.

One world of 4 gloo ranks (``parallel/dryrun.py::spawn`` of
``serve_checks``, on a ``file://`` store under the test's temporary
directory) runs every inference case once, at meshes (4, 1), (2, 2) and
(1, 4); the tests hold what its ranks wrote against the JAX package's
single-device results and, where the JAX package has one, its sharded
result on the same mesh shape over 4 of the 8 virtual CPU devices of
``tests/conftest.py``. Weights come from ``init_params`` (bit-equal in both
packages), inputs from numpy seeds.

Tolerances: tokens, lengths, specs and local shards exact; encoder states
1e-5 and a decode step's logits 1e-5 (fp32 sums in another order: the
ranks' partial sums of each row-parallel projection); beam scores 1e-5.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_threads
from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu import quantization as jax_quant
from whisper_trtllm_tpu.models.whisper import model as jax_model
from whisper_trtllm_tpu.parallel import make_mesh as jax_make_mesh
from whisper_trtllm_tpu.parallel import partition as jax_partition
from whisper_trtllm_tpu.runtime.beam import beam_decode as jax_beam_decode
from whisper_trtllm_tpu.runtime.generation import (
    transcribe_tokens as jax_transcribe,
)
from whisper_trtllm_tpu.runtime.ifb import InflightBatcher as JaxBatcher
from whisper_trtllm_tpu.runtime.session import WhisperSession as JaxSession
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch import quantization
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.parallel import dryrun, partition
from whisper_trtllm_tpu_torch.utils.device import to_numpy

WORLD = 4
# the world's own limit: a hang fails these tests, not the suite's clock
WORLD_TIMEOUT_S = 300
CFG4 = dryrun.testing_config(4, 64, 128)
MEL8 = dryrun.mels(CFG4, 8, 0)
SHAPES = [(4, 1), (2, 2), (1, 4)]


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """The world, started when the module's first test starts, while the
    tests compute the JAX package's results."""
    pool = ThreadPoolExecutor(1)
    yield pool.submit(dryrun.spawn, WORLD, "serve",
                      workdir=str(tmp_path_factory.mktemp("serve_world")),
                      cpu=True, timeout=WORLD_TIMEOUT_S,
                      env=torch_threads.rank_env())
    pool.shutdown(wait=True)


@pytest.fixture
def ranks(world):
    """What each rank of the world computed (``serve_checks``)."""
    return world.result()


def _jcfg(cfg):
    return jax_config.WhisperConfig(**dataclasses.asdict(cfg))


def _jax_greedy(cfg, mel, tokens, tree=None, mesh_shape=None):
    jcfg = _jcfg(cfg)
    gen = jax_config.GenerationConfig(max_new_tokens=tokens)
    params = tree if tree is not None else jax_model.init_params(jcfg, seed=0)
    fn = jax.jit(lambda p, m: jax_transcribe(p, jcfg, m, gen))
    if mesh_shape is None:
        out = fn(params, mel)
    else:
        mesh = jax_make_mesh(jax_config.MeshConfig(*mesh_shape),
                             devices=jax.devices()[:WORLD])
        with mesh:
            out = fn(jax_partition.shard_params(params, mesh),
                     jax.device_put(mel, NamedSharding(mesh, P("data"))))
    return tuple(np.asarray(x) for x in out)


@pytest.fixture(scope="module")
def jax_greedy4():
    return _jax_greedy(CFG4, MEL8, 8)


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("fused", [False, True])
def test_partition_specs_equal_jax(fused):
    assert partition.param_partition_specs(fused) == _tuples(
        jax_partition.param_partition_specs(fused_qkv=fused))


@pytest.mark.parametrize("kind", ["int8", "int4", "int8 vocab"])
def test_quantized_specs_equal_jax(kind):
    port = {"int8": quantization.weight_only_quantize,
            "int4": quantization.weight_only_quantize_int4,
            "int8 vocab": quantization.quantize_vocab_embedding}[kind]
    ref = {"int8": jax_quant.weight_only_quantize,
           "int4": jax_quant.weight_only_quantize_int4,
           "int8 vocab": jax_quant.quantize_vocab_embedding}[kind]
    tree = port(wmodel.init_params(CFG4, seed=0, device="cpu"))
    jtree = ref(jax_model.init_params(_jcfg(CFG4), seed=0))
    assert partition.default_specs(tree) == _tuples(
        jax_partition._adapt_specs_to_quantized(
            jtree, jax_partition.param_partition_specs()))


def test_mesh_config_round_trip_and_json_shared():
    cfg = torch_config.MeshConfig(data=2, model=4)
    assert cfg.world_size == 8 and cfg.axis_names() == ("data", "model")
    assert torch_config.MeshConfig.from_json(cfg.to_json()) == cfg
    jcfg = jax_config.MeshConfig.from_json(cfg.to_json())
    assert (jcfg.data, jcfg.model) == (2, 4)


def test_local_shards_equal_jax_addressable_shards(world):
    """(2, 2), every head count dividing: rank d·2 + m holds exactly what
    JAX puts on device [d, m] of its mesh."""
    jparams = jax_model.init_params(_jcfg(CFG4), seed=0)
    mesh = jax_make_mesh(jax_config.MeshConfig(2, 2),
                         devices=jax.devices()[:WORLD])
    sharded = jax_partition.shard_params(jparams, mesh)
    flat = jax.tree_util.tree_flatten_with_path(sharded)[0]
    ranks = world.result()
    assert len(flat) == len(ranks[0]["local (2, 2)"])
    for path, arr in flat:
        name = "/".join(k.key for k in path)
        for d in range(2):
            for m in range(2):
                dev = mesh.devices[d, m]
                shard = next(s for s in arr.addressable_shards
                             if s.device == dev)
                np.testing.assert_array_equal(
                    ranks[2 * d + m]["local (2, 2)"][name],
                    np.asarray(shard.data), err_msg=f"{name} on [{d}, {m}]")


def test_fused_qkv_cut_as_q_k_v_by_heads(ranks):
    """JAX cuts the fused dim evenly; the port cuts q, k and v each by one
    head a rank and concatenates them on the rank."""
    full = wmodel.fuse_qkv_params(wmodel.init_params(CFG4, seed=0,
                                                     device="cpu"))
    kernel = np.asarray(full["decoder"]["layers"]["self_attn"]["qkv"]["kernel"])
    q, k, v = np.split(kernel, 3, axis=-1)
    dh = CFG4.decoder_head_dim
    for m in range(WORLD):
        cols = slice(m * dh, (m + 1) * dh)
        want = np.concatenate([q[..., cols], k[..., cols], v[..., cols]], -1)
        np.testing.assert_array_equal(
            ranks[m]["local fused (1, 4)"]["decoder/layers/self_attn/qkv/kernel"],
            want)


@pytest.mark.parametrize("shape", SHAPES)
def test_greedy_equal_jax_on_every_rank(jax_greedy4, ranks, shape):
    for r in range(WORLD):
        tokens, lengths = ranks[r][f"greedy {shape}"]
        np.testing.assert_array_equal(tokens, jax_greedy4[0])
        np.testing.assert_array_equal(lengths, jax_greedy4[1])


def test_greedy_equal_jax_sharded(world):
    ref = _jax_greedy(CFG4, MEL8, 8, mesh_shape=(2, 2))
    ranks = world.result()
    np.testing.assert_array_equal(ranks[0]["greedy (2, 2)"][0], ref[0])
    np.testing.assert_array_equal(ranks[0]["greedy (2, 2)"][1], ref[1])


@pytest.mark.parametrize("name,heads,d", [("six heads", 6, 96),
                                          ("two heads", 2, 64)])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_uneven_heads_equal_jax(world, name, heads, d, shape):
    """6 heads over 4 ranks are 2, 2, 2, 0 and 2 heads are 1, 1, 0, 0: the
    ranks without heads contribute zeros to the all-reduces."""
    cfg = dryrun.testing_config(heads, d, 2 * d)
    ref = _jax_greedy(cfg, MEL8, 6)
    ranks = world.result()
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r][f"{name} {shape}"][0], ref[0])
        np.testing.assert_array_equal(ranks[r][f"{name} {shape}"][1], ref[1])


def test_uneven_heads_equal_jax_sharded(world):
    cfg = dryrun.testing_config(6, 96, 192)
    ref = _jax_greedy(cfg, MEL8, 6, mesh_shape=(1, 4))
    ranks = world.result()
    np.testing.assert_array_equal(ranks[0]["six heads (1, 4)"][0], ref[0])


def test_fused_qkv_equal_jax(jax_greedy4, ranks):
    np.testing.assert_array_equal(ranks[0]["fused (1, 4)"][0],
                                  jax_greedy4[0])
    np.testing.assert_array_equal(ranks[0]["fused (1, 4)"][1],
                                  jax_greedy4[1])


def test_int8_vocab_equal_jax(world):
    tree = jax_quant.quantize_vocab_embedding(
        jax_model.init_params(_jcfg(CFG4), seed=0))
    ref = _jax_greedy(CFG4, MEL8, 8, tree=tree)
    ranks = world.result()
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["int8 vocab (2, 2)"][0],
                                      ref[0])


def test_int8_session_equal_jax(world):
    jcfg = _jcfg(CFG4)
    sess = JaxSession(jax_model.init_params(jcfg, seed=0), jcfg,
                      jax_config.GenerationConfig(max_new_tokens=4),
                      jax_config.RuntimeConfig(weight_dtype="int8"))
    ref = sess.transcribe_features(MEL8[:4])
    ranks = world.result()
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["int8 session (2, 2)"][0],
                                      np.asarray(ref[0]))
        np.testing.assert_array_equal(ranks[r]["int8 session (2, 2)"][1],
                                      np.asarray(ref[1]))
    leaves = ranks[0]["int8 session leaves"]
    layers = CFG4.decoder_layers
    assert leaves["decoder/layers/fc1/kernel_q"].shape == (layers, 64, 64)
    assert leaves["decoder/layers/fc1/scale"].shape == (layers, 64)
    assert leaves["decoder/layers/fc2/kernel_q"].shape == (layers, 64, 64)
    assert leaves["decoder/layers/fc2/scale"].shape == (layers, 64)


@pytest.fixture(scope="module")
def jax_beams():
    jcfg = _jcfg(CFG4)
    params = jax_model.init_params(jcfg, seed=0)
    enc = jax.jit(lambda p, m: jax_model.encode(p, jcfg, m))(params,
                                                              MEL8[:4])
    gen = jax_config.GenerationConfig(max_new_tokens=6, num_beams=3)
    out = jax_beam_decode(params, jcfg, enc, gen)
    return np.asarray(enc), tuple(np.asarray(x) for x in out)


def test_encoder_states_equal_jax(jax_beams, ranks):
    np.testing.assert_allclose(ranks[0]["encoder (1, 4)"], jax_beams[0],
                               atol=1e-5, rtol=1e-5)


def test_beam_search_on_local_head_caches_equal_jax(jax_beams, ranks):
    tokens, scores, lengths = ranks[0]["beam (1, 4)"]
    np.testing.assert_array_equal(tokens, jax_beams[1][0])
    np.testing.assert_allclose(scores, jax_beams[1][1], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(lengths, jax_beams[1][2])


def test_beam_session_equal_jax(world):
    jcfg = _jcfg(CFG4)
    sess = JaxSession(jax_model.init_params(jcfg, seed=0), jcfg,
                      jax_config.GenerationConfig(max_new_tokens=6,
                                                  num_beams=2))
    ref = sess.transcribe_features(MEL8[:4])
    ranks = world.result()
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["beam session (2, 2)"][0],
                                      np.asarray(ref[0]))
        np.testing.assert_array_equal(ranks[r]["beam session (2, 2)"][1],
                                      np.asarray(ref[1]))


def test_batcher_equal_jax(world):
    jcfg = _jcfg(CFG4)
    b = JaxBatcher(jax_model.init_params(jcfg, seed=0), jcfg,
                   jax_config.GenerationConfig(max_new_tokens=8),
                   num_lanes=2, segment_steps=4)
    ids = [b.submit(m) for m in dryrun.mels(CFG4, 3, 7)]
    b.run()
    ref = [np.asarray(b.fetch(rid)) for rid in ids]
    ranks = world.result()
    for r in range(WORLD):
        for got, want in zip(ranks[r]["batcher (1, 4)"], ref):
            np.testing.assert_array_equal(got, want)


def test_decode_step_logits_equal_one_device(ranks):
    params = wmodel.init_params(CFG4, seed=0, device="cpu")
    enc = wmodel.encode(params, CFG4, torch.from_numpy(MEL8[:1]))
    cross = wmodel.compute_cross_kv(params, CFG4, enc)
    logits, _ = wmodel.decode_step_kv(
        params, CFG4, torch.tensor([1], dtype=torch.int32), 0,
        wmodel.init_self_kv(CFG4, 1, 4, device="cpu"), cross)
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["first logits (1, 4)"],
                                   to_numpy(logits), atol=1e-5, rtol=1e-5)


def test_collectives_two_an_encoder_layer_three_a_decoder_layer(ranks):
    assert ranks[0]["encoder all-reduces"] == 2 * CFG4.encoder_layers
    assert ranks[0]["decoder step all-reduces"] == 3 * CFG4.decoder_layers


@pytest.mark.parametrize("shape", ["(2, 1)", "(4, 1)", "(2, 2)"])
def test_sampled_session_over_a_data_axis_equals_one_device(ranks, shape):
    """Batch 4, temperature 1.5, top-k 20: every rank of the mesh returns
    the one-device session's tokens and lengths ((2, 1): ranks 0 and 1)."""
    members = range(2) if shape == "(2, 1)" else range(WORLD)
    for r in members:
        got, want = ranks[r][f"sampled {shape}"], ranks[r][
            "sampled one device"]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    # the draw is not the greedy decode
    assert len({tuple(t) for t in ranks[0]["sampled one device"][0]}) > 1


@pytest.mark.parametrize("case", [
    "refuse batch 3 over data 2", "refuse outside the mesh", "refuse fp8",
    "refuse smoothquant", "refuse odd int4 cut"])
def test_refusals(ranks, case):
    for r in range(WORLD):
        assert ranks[r][case], f"rank {r} did not raise: {case}"


@pytest.mark.parametrize("quantize", ["fp8", "smoothquant"])
def test_jax_shard_params_refuses_the_same_trees(quantize):
    jcfg = _jcfg(CFG4)
    params = jax_model.init_params(jcfg, seed=0)
    if quantize == "fp8":
        tree = jax_quant.fp8_quantize(params)
    else:
        stats = jax_quant.whisper_act_stats(
            params, jcfg, MEL8[:2], np.ones((2, 4), np.int32))
        tree = jax_quant.smooth_quantize_whisper(params, stats)
    mesh = jax_make_mesh(jax_config.MeshConfig(2, 2),
                         devices=jax.devices()[:WORLD])
    with pytest.raises(Exception):
        jax_partition.shard_params(tree, mesh)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_check_devices(ranks, shape):
    for r in range(WORLD):
        assert ranks[r][f"check_devices {shape}"] == {"devices": WORLD,
                                                      "ok": True}


def test_dryrun_token_equal_to_one_device(ranks):
    assert ranks[0]["dryrun"].startswith("dryrun OK: 4 ranks, mesh data=2 "
                                         "model=2")


def test_entry_points_default_to_the_card(monkeypatch):
    from whisper_trtllm_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed(init_method="file:///nonexistent",
                               world_size=1, rank=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
