"""The port's reference-checkpoint import (``compat.py``'s import half)
against the JAX package's: ``params_from_state_dict`` on state dicts in the
reference's naming for every backbone of the registry, the rejections, the
``.npz`` and ``.pt`` round trips, ``import_reference_embeddings``, and
``main`` writing a port checkpoint that the port serves, over HTTP too,
with the ids of the JAX recommender fed the same import.

The state dicts are built here with the reference's parameter names (the
reference checkout is not needed). Imported weights are copies of the
given values, so they are held exactly; ids exactly.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from gdmcf_torch import compat  # noqa: E402
from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.models.registry import BACKBONES  # noqa: E402
from gdmcf_torch.models.registry import build_model as t_build  # noqa: E402
from gdmcf_tpu import compat as jcompat  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.models.registry import build_model as j_build  # noqa: E402

N_USER, N_ITEM = 40, 30


def graph():
    rng = np.random.default_rng(0)
    return sp.csr_matrix((rng.random((N_USER, N_ITEM)) < 0.2)
                         .astype(np.float32))


def port_model(backbone, **kw):
    cfg = dict(backbone=backbone, dims=[16], emb_size=10, steps=5)
    cfg.update(kw)
    return t_build(TConfig(**cfg), N_USER, N_ITEM, train_csr=graph(),
                   generator=torch.Generator().manual_seed(0), device="cpu")


def jax_template(backbone, **kw):
    cfg = dict(backbone=backbone, dims=[16], emb_size=10, steps=5)
    cfg.update(kw)
    model = j_build(JConfig(**cfg), N_USER, N_ITEM, train_csr=graph())
    return model.init(jax.random.PRNGKey(0))


def reference_name(name: str) -> str:
    """The port's parameter name -> the reference's."""
    if name.startswith("gcn."):
        _, conv, kind = name.split(".")
        return (f"gcn_model.{conv}.lin.weight" if kind == "weight"
                else f"gcn_model.{conv}.bias")
    if name in ("embedding_item", "embedding_user"):
        return name + ".weight"
    return name


def reference_state_dict(model, seed=1, bypassed=True):
    """Random weights for every parameter of ``model``, in the reference's
    naming; an embedding backbone also gets the reference's bypassed
    out_layers (of any shape)."""
    rng = np.random.default_rng(seed)
    sd = {reference_name(k): rng.standard_normal(tuple(p.shape))
          .astype(np.float32) for k, p in model.named_parameters()}
    if bypassed and not any(k.startswith("out_layers")
                            for k, _ in model.named_parameters()):
        sd["out_layers.0.weight"] = rng.standard_normal((7, 7)).astype(
            np.float32)
        sd["out_layers.0.bias"] = rng.standard_normal(7).astype(np.float32)
    return sd


def numpy_of(params):
    return {k: v.numpy() for k, v in params.items()}


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_params_from_state_dict_matches_jax(backbone):
    model = port_model(backbone)
    template = dict(model.named_parameters())
    sd = reference_state_dict(model)
    jtemplate = jax_template(backbone)
    try:
        want = jcompat.params_from_state_dict(sd, jtemplate)
        jax_error = None
    except (KeyError, ValueError) as e:
        want, jax_error = None, e
    if backbone == "lightGCN":
        # the port keeps the propagated tables as buffers built from the
        # graph, outside the parameters; the JAX tree holds them as leaves
        # a reference state dict cannot fill
        assert isinstance(jax_error, ValueError)
        assert "frozen_lgn" in str(jax_error) and "unfilled" in str(
            jax_error)
        got = compat.params_from_state_dict(sd, template)
        assert got.keys() == template.keys()
        for k, v in numpy_of(got).items():
            np.testing.assert_array_equal(v, sd[reference_name(k)])
        return
    if jax_error is not None:
        # names the importer does not know (cat_layer, the transformer's
        # enc*): both packages refuse alike
        with pytest.raises(type(jax_error)) as e:
            compat.params_from_state_dict(sd, template)
        assert str(e.value) == str(jax_error)
        return
    got = compat.params_from_state_dict(sd, template)
    bridged = compat.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, want))
    assert got.keys() == bridged.keys() == template.keys()
    for k, v in numpy_of(got).items():
        assert v.dtype == np.float32 and v.shape == tuple(template[k].shape)
        np.testing.assert_array_equal(v, bridged[k], err_msg=k)
    # the template is read, not written
    for k, p in port_model(backbone).named_parameters():
        assert torch.equal(template[k].detach(), p.detach())


def test_imported_weights_load_and_run():
    model = port_model("DNNOneHotEmbeddingGCN")
    sd = reference_state_dict(model)
    sd["sumW"] = np.float32(0.7)
    params = compat.params_from_state_dict(sd, dict(model.named_parameters()))
    model.load_state_dict(params, strict=False)
    assert model.sumW.item() == pytest.approx(0.7)
    torch.testing.assert_close(model.gcn.conv1.weight,
                               torch.from_numpy(sd["gcn_model.conv1.lin.weight"]))
    x = (torch.rand(8, N_ITEM, generator=torch.Generator().manual_seed(0))
         < 0.3).float()
    xu = torch.stack([1 - x, x], -1)
    model.eval()
    with torch.no_grad():
        out, _ = model(x, torch.zeros(8).long(), xu, index=torch.arange(8),
                       graph=xu)
    assert out.shape == (8, N_ITEM) and torch.isfinite(out).all()


def test_import_rejects_shape_mismatch():
    model = port_model("DNN")
    sd = reference_state_dict(model)
    sd["in_layers.0.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        compat.params_from_state_dict(sd, dict(model.named_parameters()))
    with pytest.raises(ValueError, match="shape mismatch"):
        jcompat.params_from_state_dict(sd, jax_template("DNN"))


def test_import_rejects_partial_and_unknown():
    template = dict(port_model("DNN").named_parameters())
    with pytest.raises(ValueError, match="unfilled"):
        compat.params_from_state_dict({}, template)
    with pytest.raises(KeyError, match="unrecognized"):
        compat.params_from_state_dict({"mystery.weight": np.zeros(2)},
                                      template)
    # a group the model does not have is refused, out_layers skipped
    with pytest.raises(KeyError, match="in_layers2"):
        compat.params_from_state_dict(
            {"in_layers2.0.weight": np.zeros((2, 2))}, template)
    emb = dict(port_model("DNNOneHotEmbedding").named_parameters())
    sd = reference_state_dict(port_model("DNNOneHotEmbedding"))
    assert "out_layers.0.weight" in sd
    assert "out_layers.0.weight" not in compat.params_from_state_dict(sd, emb)


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_import_reference_checkpoint_round_trip(tmp_path, suffix):
    cfg = dict(backbone="DNN", dims=[16], emb_size=10, steps=5)
    sd = reference_state_dict(port_model("DNN"), seed=4)
    path = str(tmp_path / f"sd{suffix}")
    if suffix == ".npz":
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    got = compat.import_reference_checkpoint(path, TConfig(**cfg), N_USER,
                                             N_ITEM)
    if suffix == ".npz":
        want = compat.state_dict_from_jax_params(jax.tree_util.tree_map(
            np.asarray, jcompat.import_reference_checkpoint(
                path, JConfig(**cfg), N_USER, N_ITEM)))
    else:
        want = sd
    for k, v in numpy_of(got).items():
        np.testing.assert_array_equal(v, want[k])


def test_module_pickle_imports_or_names_the_way_out(tmp_path, monkeypatch):
    """A whole-module pickle imports while its class is importable; when it
    is not, the error says to re-export a state_dict."""
    import sys

    (tmp_path / "ref_model_mod.py").write_text(
        "import torch\n"
        "class Model(torch.nn.Module):\n"
        "    def __init__(self, sd):\n"
        "        super().__init__()\n"
        "        for k, v in sd.items():\n"
        "            self.register_buffer(k.replace('.', '_'), v)\n"
        "        self._names = list(sd)\n"
        "    def state_dict(self):\n"
        "        return {k: getattr(self, k.replace('.', '_'))\n"
        "                for k in self._names}\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    import ref_model_mod

    cfg = TConfig(backbone="DNN", dims=[16], emb_size=10, steps=5)
    sd = reference_state_dict(port_model("DNN"), seed=8)
    path = str(tmp_path / "model.pth")
    torch.save(ref_model_mod.Model({k: torch.from_numpy(v)
                                    for k, v in sd.items()}), path)
    got = compat.import_reference_checkpoint(path, cfg, N_USER, N_ITEM)
    for k, v in numpy_of(got).items():
        np.testing.assert_array_equal(v, sd[k])
    monkeypatch.delitem(sys.modules, "ref_model_mod")
    monkeypatch.setattr(sys, "path", [p for p in sys.path
                                      if p != str(tmp_path)])
    with pytest.raises(ModuleNotFoundError, match="state_dict"):
        compat.import_reference_checkpoint(path, cfg, N_USER, N_ITEM)


def _write_embeddings(d, shapes):
    for name, shape in shapes.items():
        torch.save(torch.randn(*shape, generator=torch.Generator()
                               .manual_seed(len(name))),
                   d / f"{name}_Embed.pt")


def test_import_reference_embeddings_matches_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    _write_embeddings(src, {"final_user": (12, 8), "final_item": (9, 8),
                            "initial_user": (12, 8),
                            "initial_item": (9, 8)})
    got = compat.import_reference_embeddings(str(src),
                                             out_dir=str(tmp_path / "port"))
    want = jcompat.import_reference_embeddings(str(src),
                                               out_dir=str(tmp_path / "jax"))
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    zp = np.load(tmp_path / "port" / "lightgcn_embeddings.npz")
    zj = np.load(tmp_path / "jax" / "lightgcn_embeddings.npz")
    assert sorted(zp.files) == sorted(zj.files)
    for k in zp.files:
        np.testing.assert_array_equal(zp[k], zj[k])


def test_import_reference_embeddings_rejects_inconsistent(tmp_path):
    _write_embeddings(tmp_path, {"final_user": (4, 8), "final_item": (3, 8),
                                 "initial_user": (4, 8),
                                 "initial_item": (3, 6)})
    with pytest.raises(ValueError, match="inconsistent"):
        compat.import_reference_embeddings(str(tmp_path))
    _write_embeddings(tmp_path, {"final_user": (4,), "final_item": (3, 8),
                                 "initial_user": (4,),
                                 "initial_item": (3, 8)})
    with pytest.raises(ValueError, match="2-D"):
        compat.import_reference_embeddings(str(tmp_path))


def test_main_writes_a_checkpoint_that_serves_the_jax_ids(tmp_path, capsys):
    """compat.main -> a port checkpoint (step 0, fresh optimizer state) ->
    Recommender.from_checkpoint and the HTTP server answer with the ids of
    the JAX recommender fed the same import."""
    from gdmcf_torch.data.loader import data_load, generate_synthetic_dataset
    from gdmcf_torch.serve import build_recommender
    from gdmcf_torch.serve_http import make_server
    from gdmcf_torch.train.checkpoint import Checkpointer
    from gdmcf_tpu.serve import Recommender as JRecommender
    from gdmcf_tpu.train.trainer import Trainer as JTrainer

    data = tmp_path / "data"
    paths = generate_synthetic_dataset(str(data), n_user=N_USER,
                                       n_item=N_ITEM, avg_degree=6, seed=3)
    train, _, _, n_user, n_item = data_load(*paths)
    kw = dict(backbone="DNNOneHotEmbeddingGCN", dims=[16], emb_size=10,
              steps=5, batch_size=8, sampling_steps=0)
    model = t_build(TConfig(**kw), n_user, n_item,
                    generator=torch.Generator().manual_seed(0), device="cpu")
    sd = reference_state_dict(model, seed=6)
    sd["sumW"] = np.float32(0.6)
    npz = str(tmp_path / "model.npz")
    np.savez(npz, **sd)
    out = str(tmp_path / "ckpt")
    compat.main([npz, "--out", out, "--device", "cpu", "--data_path",
                 str(data), "--backbone", kw["backbone"], "--dims", "[16]",
                 "--emb_size", "10", "--steps", "5", "--batch_size", "8",
                 "--sampling_steps", "0"])
    assert "step 0, fresh optimizer state" in capsys.readouterr().out
    ck = Checkpointer(out)
    assert ck.steps() == [0]
    data_ = torch.load(f"{out}/ckpt_0.pt", weights_only=True)
    assert int(data_["count"]) == 0
    assert all(not m.any() for m in data_["mu"].values())

    users = list(range(n_user))
    rec = build_recommender(TConfig(device="cpu", **kw), out, train, n_user,
                            n_item, serve_batch=8)
    got, _ = rec.recommend(users, k=10)
    jt = JTrainer(JConfig(**kw), n_user, n_item)
    params = jcompat.import_reference_checkpoint(npz, JConfig(**kw), n_user,
                                                 n_item)
    jrec = JRecommender.from_state(
        jt, jt.init_state()._replace(params=params), train, serve_batch=8)
    want, _ = jrec.recommend(users, k=10)
    np.testing.assert_array_equal(got, want)

    srv = make_server(rec, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = (f"http://127.0.0.1:{srv.server_address[1]}/recommend?users="
               "0,5,39&k=10")
        with urllib.request.urlopen(url, timeout=60) as r:
            body = json.loads(r.read())
        np.testing.assert_array_equal(body["items"], want[[0, 5, 39]])
    finally:
        srv.shutdown()
        srv.server_close()
