"""Command-line trainer: the reference's ``main.py`` recipe on the port.

    python -m gdmcf_torch.cli -c configs/yelpOneEmbGcn.yaml
    python -m gdmcf_torch.cli -c configs/yelpOneEmbGcn.yaml --device cpu \\
        --data_path ./Datasets/yelp_clean/ --epochs 10 --debug true

A (dp, mp) mesh runs one process per rank under the env contract of
``parallel.multihost.initialize`` (COORDINATOR_ADDRESS, NUM_PROCESSES,
PROCESS_ID), e.g. four ranks of ``--mesh_dp 2 --mesh_mp 2``:

    for r in 0 1 2 3; do COORDINATOR_ADDRESS=127.0.0.1:29500 \
        NUM_PROCESSES=4 PROCESS_ID=$r python -m gdmcf_torch.cli \
        --mesh_dp 2 --mesh_mp 2 --device cpu ... & done; wait

Every rank trains; the main rank alone writes the output.

Runs on ``cuda`` unless ``--device cpu``. Output goes to
``<log_name>/<dataset>/<YYYYMMDD>/<out_name>/``: ``output_NDCG.txt`` (stdout
is redirected there unless ``--debug``) and ``metrics.jsonl``. When the
data directory holds no splits, a synthetic dataset is written there first;
a directory holding only some of the splits is refused.
"""

from __future__ import annotations

import os
import sys
import time
from datetime import datetime

from gdmcf_torch.config import Config, parse_args
from gdmcf_torch.data.loader import data_load, generate_synthetic_dataset
from gdmcf_torch.parallel.multihost import is_main_process, sync_hosts
from gdmcf_torch.train.trainer import Trainer
from gdmcf_torch.utils.logging import MetricLogger


def main(cfg: Config = None) -> None:
    if cfg is None:
        cfg = parse_args()
    if cfg.mesh_dp * cfg.mesh_mp > 1:
        from gdmcf_torch.parallel import multihost

        multihost.initialize(device=cfg.device)
        if not multihost.is_main_process():   # the main rank writes
            with open(os.devnull, "w") as quiet:
                stdout, sys.stdout = sys.stdout, quiet
                try:
                    _run(cfg, None, None)
                finally:
                    sys.stdout = stdout
            return
    out_path = os.path.join(cfg.log_name, cfg.dataset,
                            datetime.now().strftime("%Y%m%d"), cfg.out_name)
    os.makedirs(out_path, exist_ok=True)
    out_file = os.path.join(out_path, "output_NDCG.txt")
    stdout = sys.stdout
    if not cfg.debug:
        sys.stdout = open(out_file, "w")
    try:
        _run(cfg, out_path, out_file)
    finally:
        if sys.stdout is not stdout:
            sys.stdout.close()
            sys.stdout = stdout


def _run(cfg: Config, out_path: str, out_file: str) -> None:
    print("out_path:", out_path, out_file)
    print("args:", cfg.to_dict())
    print("Starting time: ",
          time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(time.time())))

    # os.path.join, not string concatenation: a data_path without a
    # trailing slash would miss the real files, and the synthetic fallback
    # would then overwrite the user's dataset
    train_path = os.path.join(cfg.data_path, "train_list.npy")
    valid_path = os.path.join(cfg.data_path, "valid_list.npy")
    test_path = os.path.join(cfg.data_path, "test_list.npy")
    missing = not os.path.exists(train_path)
    # on a mesh every rank looks before the main rank writes, and reads
    # after it has written
    sync_hosts("data")
    if missing:
        if any(os.path.exists(p) for p in (valid_path, test_path)):
            raise FileNotFoundError(
                f"{train_path} is missing but sibling split files exist in "
                f"{cfg.data_path} — refusing to overwrite a partial dataset "
                "with synthetic data")
        print(f"{train_path} missing; generating synthetic dataset")
        if is_main_process():
            generate_synthetic_dataset(cfg.data_path)
    sync_hosts("data")

    train_data, valid_y_data, test_y_data, n_user, n_item = data_load(
        train_path, valid_path, test_path)
    density = train_data.sum() / (n_user * n_item)
    print(f"user num: {n_user}")
    print(f"item num: {n_item}")
    print(f"density: {density:.6f}")
    print("data ready.")

    trainer = Trainer(cfg, n_user=n_user, n_item=n_item,
                      train_csr=train_data)
    print(f"models ready on {trainer.device}.")
    if out_path is None:   # a mesh rank other than the main one
        trainer.fit(train_data, valid_y_data, test_y_data)
        return
    metric_logger = MetricLogger(out_path, echo=cfg.debug, text=cfg.debug)
    # debug: stdout is the console, so fit's lines also go through the
    # logger into output_NDCG.txt; otherwise stdout already is that file
    # and the logger's own text handle stays closed
    trainer.fit(train_data, valid_y_data, test_y_data,
                log=metric_logger.log if cfg.debug else print,
                metric_logger=metric_logger)
    metric_logger.close()
    print("End time: ",
          time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(time.time())))


if __name__ == "__main__":
    main(parse_args())
