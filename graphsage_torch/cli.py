"""Command-line training: the compact, leaf-cached and distributed
pipelines.

Port of ``graphsage_tpu/cli.py``, with the
reference CLI's flags (reference src/main.py:12-27): ``--dataSet --agg_func
--epochs --b_sz --seed --gcn --learn_method --unsup_loss --max_vali_f1
--name`` (``--cuda`` is accepted and ignored; ``--device`` chooses).
Training runs on the card unless ``--device cpu`` is given.  ``--export
DIR`` writes the best-val model as a serving bundle that
``graphsage_torch.infer`` loads.

    python -m graphsage_torch.cli --dataSet powerlaw:2000:10000 --epochs 2
    python -m graphsage_torch.cli --dataSet powerlaw:2000:10000 \
        --pipeline cached --table_cap 8 --learn_method plus_unsup --epochs 2

``--agg_func MEAN|MAX|LSTM|POOL`` trains on ``--pipeline compact`` (the
all-LSTM model shuffles each row's slots; POOL, GraphSAGE-pool, takes
``--pool_size`` and is refused by every other pipeline).  ``--pipeline cached``
(``train.CachedTrainer``) takes ``--table_cap``, ``--refresh_every``,
``--no_extend`` and ``--lstm_hybrid``, and trains MEAN, MAX and, with
``--agg_func LSTM --lstm_hybrid``, the cached-LSTM hybrid, whose ``--export``
bundle records ``meta["lstm_hybrid"]`` so that serving runs the hybrid
forward.  ``--compute_dtype bfloat16`` trains either pipeline in bfloat16
with float32 master params; the ``--export`` bundle records the compute
dtype, and ``graphsage_torch.infer`` serves it in that dtype.  The dense
pipeline (``graphsage_torch.train.dense``) is a library API, with no
``--pipeline`` of its own, as in the JAX package.

``--pipeline cached_dist`` (``train.CachedDistTrainer``, the row-sharded
cached pipeline) and ``--pipeline dist`` (``train.DistTrainer``, the
edge-partitioned halo pipeline) run one process a rank: under ``torchrun``
the world size and the rendezvous come from the environment, and without
it the run is a world of 1 (``parallel.multihost.initialize``: NCCL on
the card, gloo with ``--device cpu``).  ``--b_sz`` is the global batch:
``dist`` trains ``max(1, b_sz // world)`` rows a rank, ``cached_dist``
rounds it up to a multiple of the world size.  Rank 0 alone prints,
checkpoints and exports; ``--resume`` restores the replicated params (and
the cached_dist sampler's key generator) on every rank; a wedged fetch
exits 17 from whichever rank hits it.

    torchrun --standalone --nproc_per_node 2 -m graphsage_torch.cli \
        --dataSet powerlaw:2000:10000 --device cpu --pipeline dist

Checkpoints and resume: on every val improvement the run writes
``<--checkpoint_dir>/model_best_<name>_ep<E>_<testF1>`` (the JAX package's
name; ``utils/checkpoint.py``'s format), and ``--resume PATH`` continues a
run from one.  ``--config FILE`` reads a HOCON experiment file
(``setting.num_layers``, ``setting.hidden_emb_size``; ``--num_layers`` and
``--hidden`` override it).  When a deadline-guarded device fetch expires
(``utils/obs.py``), the process prints ``FATAL: ...`` and exits with code
17; ``python -m graphsage_torch.supervise`` relaunches it with ``--resume``.

    python -m graphsage_torch.cli --dataSet powerlaw:2000:10000 \
        --agg_func LSTM --epochs 1
    python -m graphsage_torch.cli --dataSet powerlaw:2000:10000 \
        --pipeline cached --agg_func LSTM --lstm_hybrid --epochs 2 \
        --export bundles/hybrid
    python -m graphsage_torch.cli --dataSet powerlaw:2000:10000 \
        --compute_dtype bfloat16 --pipeline cached --table_cap 8 --epochs 2
    python -m graphsage_torch.cli --dataSet powerlaw:2000:10000 \
        --epochs 3 --name run --resume checkpoints/model_best_run_ep0_0.3300
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# the exit code of a run whose device fetch wedged: restart and resume
WEDGE_EXIT = 17


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="GraphSAGE training on the card (graphsage_torch)")
    # reference-compatible flags (src/main.py:14-26)
    p.add_argument("--dataSet", type=str, default="cora")
    p.add_argument("--agg_func", type=str, default="MEAN",
                   choices=["MEAN", "MAX", "LSTM", "POOL"])
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--b_sz", type=int, default=20)
    p.add_argument("--seed", type=int, default=824)
    p.add_argument("--cuda", action="store_true",
                   help="accepted for CLI compatibility; ignored (--device "
                        "chooses)")
    p.add_argument("--gcn", action="store_true")
    p.add_argument("--learn_method", type=str, default="sup",
                   choices=["sup", "unsup", "plus_unsup"])
    p.add_argument("--unsup_loss", type=str, default="normal",
                   choices=["normal", "margin"])
    p.add_argument("--max_vali_f1", type=float, default=0)
    p.add_argument("--name", type=str, default="debug")
    p.add_argument("--config", type=str, default=None,
                   help="HOCON experiment file (reference-compatible)")
    # framework flags
    p.add_argument("--pipeline", type=str, default="compact",
                   choices=["compact", "cached", "cached_dist", "dist"],
                   help="compact = the per-step reference-parity path; "
                        "cached = the leaf-cached path (LSTM needs "
                        "--lstm_hybrid); cached_dist = the cached path "
                        "row-sharded over the ranks; dist = the "
                        "edge-partitioned halo path (torchrun for more "
                        "than one rank)")
    p.add_argument("--table_cap", type=int, default=None,
                   help="cached pipeline: cap the padded adjacency width "
                        "(a uniform subset per row); None = full degree")
    p.add_argument("--lstm_hybrid", action="store_true",
                   help="cached pipeline + --agg_func LSTM: the hybrid "
                        "variant (MEAN leaf cache, live LSTM cells above)")
    p.add_argument("--refresh_every", type=int, default=1,
                   help="cached pipeline: refresh the leaf cache every k "
                        "epochs")
    p.add_argument("--no_extend", action="store_true",
                   help="cached pipeline: plain fixed-size supervised "
                        "batches instead of the reference's pair-extended "
                        "batches")
    p.add_argument("--pool_size", type=int, default=512,
                   help="--agg_func POOL: the pool MLP's width (the "
                        "authors' 512 small, 1024 big)")
    p.add_argument("--fanout", type=int, default=10)
    p.add_argument("--num_layers", type=int, default=None,
                   help="override config setting.num_layers (default 2)")
    p.add_argument("--hidden", type=int, default=None,
                   help="override config setting.hidden_emb_size (default "
                        "128)")
    p.add_argument("--lr", type=float, default=0.7)
    p.add_argument("--clf_epochs", type=int, default=800)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path to resume from")
    p.add_argument("--strict_clf_eval", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="re-embed val/test each classifier epoch like the "
                        "reference (default); --no-strict_clf_eval scores "
                        "on cached embeddings")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--data_root", type=str, default=None,
                   help="dataset directory override")
    p.add_argument("--export", type=str, default=None,
                   help="after training, write the best-val model as a "
                        "serving bundle to this directory")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain versions)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--metrics", type=str, default=None,
                   help="path for jsonl structured metrics")
    return p


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None):
    """What ``main`` runs: parse, train, export.  Returns the trainer and
    the best-val snapshot ({"params", "epoch", "test_f1"}) that
    ``--export`` ships."""
    args = build_parser().parse_args(argv)
    distributed = args.pipeline in ("cached_dist", "dist")
    device, rank, world, owned = args.device, 0, 1, False
    if distributed:
        import torch.distributed as dist

        from graphsage_torch.parallel import comm, multihost
        owned = not dist.is_initialized()   # a caller's group stays up
        device = multihost.initialize(args.device)
        rank, world = comm.rank_world()
    try:
        return _run(args, device, rank, world)
    finally:
        if owned:
            multihost.shutdown()


def _run(args, device, rank: int, world: int):
    from graphsage_torch.convert import params_to_numpy
    from graphsage_torch.data import load_dataset
    from graphsage_torch.infer import export_bundle
    from graphsage_torch.models import GraphSageConfig
    from graphsage_torch.train import (CachedDistTrainer, CachedTrainer,
                                       DistTrainConfig, DistTrainer, Trainer,
                                       TrainConfig)
    from graphsage_torch.train.trainer import _leaf_params
    from graphsage_torch.utils.checkpoint import (checkpoint_test_f1,
                                                  restore_checkpoint,
                                                  save_checkpoint,
                                                  set_generator_state)
    from graphsage_torch.utils.config import load_config
    ready = time.time()
    # rank 0 alone prints, checkpoints and exports
    quiet = args.quiet or rank != 0
    metrics = args.metrics if rank == 0 else None

    num_layers, hidden = 2, 128  # reference src/experiments.conf:11-12
    if args.config:
        cfg = load_config(args.config)
        num_layers = cfg.get("setting.num_layers", num_layers)
        hidden = cfg.get("setting.hidden_emb_size", hidden)
    if args.num_layers is not None:
        num_layers = args.num_layers
    if args.hidden is not None:
        hidden = args.hidden

    kw = {"root": args.data_root} if args.data_root else {}
    ds = load_dataset(args.dataSet, seed=args.seed, **kw)
    if ds.synthetic_features and not quiet:
        print(f"NOTE: content file for {ds.name} absent; using synthesized "
              "features over the real graph")
    data_s = time.time() - ready

    mcfg = GraphSageConfig(num_layers=num_layers, input_size=ds.feature_dim,
                           out_size=hidden, gcn=args.gcn,
                           agg_func=args.agg_func,
                           compute_dtype=args.compute_dtype,
                           pool_size=args.pool_size)
    tcfg = TrainConfig(
        learn_method=args.learn_method, unsup_loss=args.unsup_loss,
        b_sz=args.b_sz, epochs=args.epochs, lr=args.lr, seed=args.seed,
        fanout=args.fanout, clf_epochs=args.clf_epochs,
        strict_clf_eval=args.strict_clf_eval, verbose=not quiet,
        metrics_path=metrics, refresh_every=args.refresh_every)

    # best-val params snapshot: checkpoint_fn fires exactly on val
    # improvement, so the last snapshot is the model that reached
    # max_vali_f1, which --export ships
    best = {"params": None, "epoch": None, "test_f1": None}

    def checkpoint_fn(trainer, test_f1):
        best["params"] = params_to_numpy(trainer.params)
        best["epoch"] = trainer.epoch
        best["test_f1"] = float(test_f1)
        if rank != 0:
            return
        path = os.path.join(
            args.checkpoint_dir,
            f"model_best_{args.name}_ep{trainer.epoch}_{test_f1:.4f}")
        try:
            save_checkpoint(path, best["params"], trainer.epoch,
                            trainer.max_vali_f1, trainer.rng,
                            generator=_sampler_generator(trainer),
                            test_f1=best["test_f1"])
        except OSError as e:  # keep training if the write fails
            print(f"checkpoint failed: {e}", flush=True)
            return
        if not quiet:
            print(f"checkpointed {path}")

    t0 = time.time()
    if args.pipeline == "dist":
        dcfg = DistTrainConfig(
            learn_method=args.learn_method, unsup_loss=args.unsup_loss,
            b_loc=max(1, args.b_sz // world), epochs=args.epochs,
            lr=args.lr, fanout=args.fanout, seed=args.seed,
            clf_epochs=args.clf_epochs, verbose=not quiet,
            metrics_path=metrics)
        trainer = DistTrainer(ds, mcfg, dcfg, checkpoint_fn=checkpoint_fn,
                              device=device)
    elif args.pipeline in ("cached", "cached_dist"):
        cls = (CachedDistTrainer if args.pipeline == "cached_dist"
               else CachedTrainer)
        trainer = cls(ds, mcfg, tcfg, checkpoint_fn=checkpoint_fn,
                      table_cap=args.table_cap,
                      extend_batches=not args.no_extend,
                      lstm_hybrid=args.lstm_hybrid, device=device)
    else:
        trainer = Trainer(ds, mcfg, tcfg, checkpoint_fn=checkpoint_fn,
                          device=device)
    trainer.max_vali_f1 = args.max_vali_f1
    setup_s = time.time() - t0

    if args.resume:
        t0 = time.time()
        params, epoch, best_f1, rng, gen_state = restore_checkpoint(
            args.resume, trainer.params, with_generator_state=True)
        generator = _sampler_generator(trainer)
        if gen_state is not None and generator is not None:
            # the cached pipelines' sampler: the resumed run draws the
            # unbroken run's samples
            set_generator_state(generator, gen_state)
        trainer.params = _leaf_params(params, trainer.device)
        # the checkpoint records the epoch it was written in; training
        # continues at the next one, and the checkpoint is the best-val
        # snapshot until the resumed run improves on it
        trainer.epoch = epoch + 1
        trainer.max_vali_f1 = best_f1
        trainer.rng = rng
        best.update(params=params, epoch=epoch,
                    test_f1=checkpoint_test_f1(args.resume))
        trainer.metrics.log("resume", checkpoint=args.resume,
                            after_epoch=epoch, best_val_f1=best_f1,
                            ready_wall=ready, data_s=data_s,
                            setup_s=setup_s, restore_s=time.time() - t0,
                            wall=time.time())
        if not quiet:
            print(f"resumed from {args.resume} after epoch {epoch}, "
                  f"best val F1 {best_f1:.4f}")

    if rank == 0:
        if args.learn_method == "sup":
            print("GraphSage with Supervised Learning")
        elif args.learn_method == "plus_unsup":
            print("GraphSage with Supervised Learning plus Net "
                  "Unsupervised Learning")
        else:
            print("GraphSage with Net Unsupervised Learning")

    fit_or_exit(trainer)
    if rank == 0:
        print(f"Best validation F1: {trainer.max_vali_f1:.4f}")
    if args.export and rank == 0:
        meta = {"dataset": ds.name, "name": args.name,
                "best_val_f1": float(trainer.max_vali_f1),
                "epoch": best["epoch"], "test_f1": best["test_f1"],
                "params": "best-val"}
        if (args.lstm_hybrid and args.agg_func == "LSTM"
                and args.pipeline in ("cached", "cached_dist")):
            # the trained topology is MEAN at layer 1 and LSTM above;
            # InferenceSession.from_bundle reads this and serves it
            meta["lstm_hybrid"] = True
        export_params = best["params"]
        if export_params is None:  # no improvement was ever recorded
            export_params = params_to_numpy(trainer.params)
            meta["params"] = "final-epoch"
        export_bundle(args.export, export_params, mcfg, ds.num_classes,
                      meta=meta)
        if not quiet:
            print(f"exported serving bundle to {args.export} "
                  f"({meta['params']} params)")
    return trainer, best


def _sampler_generator(trainer):
    """The generator whose state a checkpoint keeps: the cached pipeline's
    device sampler's, cached_dist's replicated key generator (the same on
    every rank), None for the compact and dist pipelines, whose sampling is
    all on the host RandomState."""
    if hasattr(trainer, "key_generator"):
        return trainer.key_generator
    return getattr(getattr(trainer, "hop", None), "generator", None)


def fit_or_exit(trainer) -> None:
    """``trainer.fit()``; when a guarded device fetch passes its deadline,
    print ``FATAL: ...`` and end the process at once with
    :data:`WEDGE_EXIT`, which the supervisor relaunches with ``--resume``.
    ``os._exit`` skips the interpreter's teardown, which could wait on the
    hung kernel forever; stdout is flushed first, and the metrics file is
    closed after each record."""
    from graphsage_torch.utils.obs import FetchDeadlineError

    try:
        trainer.fit()
    except FetchDeadlineError as e:
        print(f"FATAL: {e}; restart and resume from the last checkpoint",
              flush=True)
        sys.stderr.flush()
        os._exit(WEDGE_EXIT)


if __name__ == "__main__":
    raise SystemExit(main())
