"""The port's training and pretraining CLIs and serving from its
checkpoints, on the CPU at a tiny size. Serving from a checkpoint must
return exactly the ids of the in-memory trainer it was saved from (same
users, same generator seed)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gdmcf_torch import cli, pretrain_cli  # noqa: E402
from gdmcf_torch.config import parse_args  # noqa: E402
from gdmcf_torch.data.loader import (data_load_dir,  # noqa: E402
                                     generate_synthetic_dataset)
from gdmcf_torch.serve import Recommender, build_recommender  # noqa: E402
from gdmcf_torch.serve import main as serve_main  # noqa: E402
from gdmcf_torch.train.trainer import Trainer  # noqa: E402

SMALL = dict(n_user=60, n_item=40, avg_degree=8, seed=1)
FLAGS = ["--device", "cpu", "--dims", "[8]", "--batch_size", "16",
         "--steps", "5", "--noise_scale", "0.01", "--sampling_steps", "0",
         "--lr", "1e-3", "--topN", "[5, 10]", "--epochs", "2",
         "--eval_every", "1", "--dataset", "tiny"]


def run_cli(tmp_path, debug, data="data"):
    cfg = parse_args(FLAGS + ["--data_path", str(tmp_path / data),
                              "--log_name", str(tmp_path / "log"),
                              "--debug", debug])
    cli.main(cfg)
    (day,) = os.listdir(tmp_path / "log" / "tiny")
    return tmp_path / "log" / "tiny" / day / cfg.out_name


@pytest.mark.parametrize("debug", ["true", "false"])
def test_cli_trains_on_the_cpu_and_writes_its_outputs(tmp_path, capsys,
                                                      debug):
    generate_synthetic_dataset(str(tmp_path / "data"), **SMALL)
    out = run_cli(tmp_path, debug)
    text = (out / "output_NDCG.txt").read_text()
    assert "End. Best Epoch" in text and "models ready on cpu" in (
        text + capsys.readouterr().out)
    records = [json.loads(x) for x in
               (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["split"] for r in records if "split" in r] == [
        "valid", "test", "valid", "test"]
    assert [r["step"] for r in records if "train_loss" in r] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in records
               if "train_loss" in r)
    assert "recall@10" in records[0]
    if debug == "false":   # stdout went to the file and is restored
        assert "[Valid]" in text and "user num: 60" in text


def test_cli_generates_missing_data_and_refuses_a_partial_dataset(
        tmp_path, monkeypatch):
    made = []

    def small(path):
        made.append(path)
        return generate_synthetic_dataset(path, **SMALL)

    monkeypatch.setattr(cli, "generate_synthetic_dataset", small)
    out = run_cli(tmp_path, "true", data="fresh")
    assert made == [str(tmp_path / "fresh")]
    assert "End. Best Epoch" in (out / "output_NDCG.txt").read_text()
    os.makedirs(tmp_path / "partial")
    np.save(tmp_path / "partial" / "valid_list.npy", np.zeros((1, 2), int))
    with pytest.raises(FileNotFoundError, match="partial dataset"):
        run_cli(tmp_path, "true", data="partial")
    assert made == [str(tmp_path / "fresh")]


def test_serving_from_a_checkpoint_returns_the_trainers_ids(tmp_path,
                                                           capsys):
    generate_synthetic_dataset(str(tmp_path / "data"), **SMALL)
    train, valid, test, n_user, n_item = data_load_dir(str(tmp_path / "data"))
    ckpt = str(tmp_path / "ck")
    cfg = parse_args(FLAGS + ["--epochs", "1", "--ckpt_dir", ckpt])
    trainer = Trainer(cfg, n_user, n_item, train_csr=train)
    trainer.fit(train, valid, test, log=lambda *a: None)
    users = [0, 7, 59, 31]
    kw = dict(serve_batch=8, k_max=12, device="cpu")
    live = build_recommender(cfg, None, train, n_user, n_item,
                             trainer=trainer, **kw)
    loaded = build_recommender(cfg, ckpt, train, n_user, n_item, **kw)
    assert isinstance(loaded, Recommender) and loaded.ckpt_dir == ckpt
    assert loaded.trainer is not trainer
    for k in (12, 5):
        want, _ = live.recommend(users, k=k)
        got, _ = loaded.recommend(users, k=k)
        np.testing.assert_array_equal(got, want)
    # the serve CLI loads the same checkpoint
    capsys.readouterr()
    serve_main(FLAGS + ["--data_path", str(tmp_path / "data"),
                        "--ckpt_dir_serve", ckpt, "--users", "0,7",
                        "--k", "4", "--serve_batch", "8", "--k_max", "12"])
    out = capsys.readouterr().out
    assert f"loaded checkpoint from {ckpt}" in out and "user 7: top-4" in out
    with pytest.raises(FileNotFoundError, match="does not exist"):
        build_recommender(cfg, str(tmp_path / "typo"), train, n_user,
                          n_item, **kw)


def test_pretrain_cli_writes_the_embeddings_on_the_cpu(tmp_path, capsys):
    generate_synthetic_dataset(str(tmp_path / "data"), **SMALL)
    train, _, _, n_user, n_item = data_load_dir(str(tmp_path / "data"))
    out = tmp_path / "emb"
    pretrain_cli.main(["--device", "cpu", "--data_path",
                       str(tmp_path / "data"), "--epochs", "2",
                       "--batch_size", "32", "--latent_dim", "8",
                       "--n_layers", "2", "--out_dir", str(out)])
    text = capsys.readouterr().out
    assert f"{n_user} users x {n_item} items on cpu" in text
    assert text.count("ndcg@10") == 2
    with np.load(out / "lightgcn_embeddings.npz") as z:
        shapes = {k: z[k].shape for k in z.files}
        assert all(np.isfinite(z[k]).all() for k in z.files)
    assert shapes == {"final_user_Embed": (n_user, 8),
                      "final_item_Embed": (n_item, 8),
                      "initial_user_Embed": (n_user, 8),
                      "initial_item_Embed": (n_item, 8)}


def test_pretrain_cli_generates_missing_data_and_needs_a_card_by_default(
        tmp_path, monkeypatch):
    made = []

    def small(path):
        made.append(path)
        return generate_synthetic_dataset(path, **SMALL)

    monkeypatch.setattr("gdmcf_torch.data.loader.generate_synthetic_dataset",
                        small)
    flags = ["--data_path", str(tmp_path / "fresh"), "--epochs", "1",
             "--latent_dim", "4", "--n_layers", "1", "--out_dir",
             str(tmp_path / "emb")]
    pretrain_cli.main(flags + ["--device", "cpu"])
    assert made == [str(tmp_path / "fresh")]
    assert (tmp_path / "emb" / "lightgcn_embeddings.npz").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_cli.main(flags)
