"""LightGCN pretraining CLI: the reference's standalone ``lightGCN.py``
script as an entry point on the port.

    python -m gdmcf_torch.pretrain_cli --data_path ./Datasets/yelp_clean/ \\
        --epochs 30 --latent_dim 64 --n_layers 3 --out_dir ./embeddings
    python -m gdmcf_torch.pretrain_cli --device cpu --data_path DIR ...

``--ssl_reg`` above 0 trains SGL-ED instead (two edge-dropped views
redrawn each epoch, each dropping ``--ssl_ratio`` of the interactions,
and a whole-table InfoNCE at temperature ``--ssl_temp`` weighted by
``--ssl_reg``; ``models.sgl``), writing the same tables.

Runs on ``cuda`` unless ``--device cpu``. Writes
``<out_dir>/lightgcn_embeddings.npz`` with the four tables the reference
saves as .pt files (final/initial x user/item). When the data directory
holds no ``train_list.npy``, a synthetic dataset is written there first.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_path", type=str, required=True)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--latent_dim", type=int, default=64)
    ap.add_argument("--n_layers", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.005)
    ap.add_argument("--decay", type=float, default=1e-4)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ssl_reg", type=float, default=0.0,
                    help="SGL-ED's InfoNCE weight; 0 (the default) trains "
                    "LightGCN alone")
    ap.add_argument("--ssl_ratio", type=float, default=0.1,
                    help="the share of interactions a view drops")
    ap.add_argument("--ssl_temp", type=float, default=0.2,
                    help="the InfoNCE's temperature")
    ap.add_argument("--out_dir", type=str, default="./embeddings")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from gdmcf_torch import resolve_device
    from gdmcf_torch.data.loader import data_load, generate_synthetic_dataset
    from gdmcf_torch.models.lightgcn import pretrain, save_embeddings

    device = resolve_device(args.device)
    train_path = os.path.join(args.data_path, "train_list.npy")
    if not os.path.exists(train_path):
        print(f"{train_path} missing; generating synthetic dataset")
        generate_synthetic_dataset(args.data_path)
    train, _valid, test, n_user, n_item = data_load(
        train_path,
        os.path.join(args.data_path, "valid_list.npy"),
        os.path.join(args.data_path, "test_list.npy"))
    what = "LightGCN" if args.ssl_reg <= 0 else (
        f"SGL-ED (ssl_reg {args.ssl_reg}, ssl_ratio {args.ssl_ratio}, "
        f"ssl_temp {args.ssl_temp})")
    print(f"pretraining {what} on {n_user} users x {n_item} items "
          f"on {device}")
    result = pretrain(train, test, n_layers=args.n_layers,
                      latent_dim=args.latent_dim, epochs=args.epochs,
                      batch_size=args.batch_size, lr=args.lr,
                      decay=args.decay, k=args.k, seed=args.seed,
                      device=device, ssl_reg=args.ssl_reg,
                      ssl_ratio=args.ssl_ratio, ssl_temp=args.ssl_temp)
    save_embeddings(result, args.out_dir)
    print(f"saved embeddings to {args.out_dir}/lightgcn_embeddings.npz")


if __name__ == "__main__":
    main()
