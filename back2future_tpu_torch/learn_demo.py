"""End-to-end learning demonstration of the port on generated RoamingImages
(counterpart of tools/learn_demo.py: the same flags, defaults, stages,
errors and report keys).

Runs the reference's own flagship recipe (README.md:83-103) on a
`python -m back2future_tpu_torch.data.roaming` dataset (exact gt flow +
z-buffer occlusions in the reference's manifest format) and shows that
the port *learns*: EPE on a held-out split falling below the zero-flow
baseline, occlusion accuracy above chance, and the soft fine-tune
surgery working on trained weights:

  stage 0  saddle escape   the hard recipe on a tiny (~10-scene)
                           disjoint-seed roaming set with full-set
                           deterministic batches (--batch >= n_scenes +
                           --scene_batches full: identical batch
                           composition every step). The unsupervised
                           OBCC objective has a zero-flow saddle at init;
                           gradient consistency across steps escapes it
                           (docs/evidence/learning_demo/attempt2/).
  stage 1  hard pretrain   -pme 1 -pme_criterion OBCC -smooth_flow 2
                           (README.md:83-87, RoamingImages defaults),
                           widened over a curriculum (default one
                           30-scene level, then the full train set), each
                           level a deterministic round-robin scene sweep
                           (--scene_batches full).
  stage 2  soft fine-tune  -pme_criterion OBGCC -pme_alpha 1 -pme_beta 0
                           -pme_gamma 0 -smooth_flow 0.1 -LR 1e-5
                           -smooth_second_order -const_vel 0.0001
                           -past_flow -convert_to_soft -retrain <stage1>
                           (the clean-data Sintel variant, README.md:98-103)
  eval     `python -m back2future_tpu_torch.eval` on the val split after
           each stage, plus the zero-flow EPE baseline and a past-flow
           sanity check (linear motion => past flow ~ negated future
           flow, pwc.lua:438).

Stages run `python -m back2future_tpu_torch.main` (on the card unless
--train_args holds `--platform cpu`) and write `model_<e>.pt`
checkpoints under --cache. Writes `<out>/learning_demo.json` plus the
raw train/test logs:

    python -m back2future_tpu_torch.data.roaming --out /data/roaming --n 300
    python -m back2future_tpu_torch.learn_demo --data /data/roaming \\
        --escape_data /data/roam_escape --cache /data/learn_demo_ckpt
"""

from __future__ import annotations

import argparse
import json
import shlex
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
_TMP = Path(tempfile.gettempdir())


def run_cli(args, label):
    cmd = [sys.executable, "-m", "back2future_tpu_torch.main"] + args
    print(f"\n=== {label} ===\n+ {' '.join(cmd[1:])}", flush=True)
    t0 = time.time()
    rc = subprocess.run(cmd, cwd=REPO).returncode
    print(f"[{label}] wall {time.time() - t0:.1f}s rc={rc}", flush=True)
    if rc != 0:
        sys.exit(rc)


def run_eval(ckpt, data, label, batch=8, extra=()):
    """Eval a checkpoint on the val split. Non-fatal: a missing checkpoint
    or a failing eval returns {"error": ...} so the partial report (and
    the copied train/test logs) still gets written."""
    ckpt = Path(ckpt)
    if not ckpt.exists():
        msg = f"checkpoint not found: {ckpt}"
        print(f"[eval:{label}] SKIP — {msg}", flush=True)
        return {"error": msg}
    cmd = [sys.executable, "-m", "back2future_tpu_torch.eval",
           "--checkpoint", str(ckpt), "--dataset", "RoamingImages",
           "--datasets_dir", str(Path(data) / "datasets"),
           "--data_root", str(Path(data) / "data"), "--split", "val",
           "--batchSize", str(batch)] + list(extra)
    print(f"\n=== eval:{label} ===\n+ {' '.join(cmd[1:])}", flush=True)
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    print(out.stdout + out.stderr, flush=True)
    if out.returncode != 0:
        return {"error": f"eval rc={out.returncode}",
                "tail": (out.stdout + out.stderr)[-2000:]}
    try:
        metrics = json.loads(out.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError) as e:
        return {"error": f"eval output unparsable: {e}"}
    print(f"[eval:{label}] {metrics}", flush=True)
    return metrics


def zero_flow_baseline(data: Path) -> dict:
    """EPE of predicting zero flow on the val split = mean |gt| px,
    and the all-visible occlusion-accuracy chance level."""
    from back2future_tpu_torch.data import load_manifest, load_split
    from back2future_tpu_torch.io.flow_io import load_disp, load_flo

    specs = load_manifest(data / "datasets" / "RoamingImages.dat",
                          ground_truth=True, root=str(data / "data"))
    _, val = load_split(data / "datasets" / "RoamingImages_split.dat")
    epes, occ_acc = [], []
    for i in val:
        s = specs[int(i)]
        flo = Path(s.flow_pattern % s.ref)
        flow = load_flo(flo)
        epes.append(float(np.mean(np.hypot(flow[..., 0], flow[..., 1]))))
        occ = load_disp(flo.with_name(flo.stem + "_occ_3.disp"))
        # majority-class chance level: predict "visible" (= 0.5 in the
        # {0, .5, 1} encoding, flowExtensions.lua:172-239) everywhere
        occ_acc.append(float(np.mean(occ == 0.5)))
    return {"zero_flow_epe": float(np.mean(epes)),
            "all_visible_occ_acc": float(np.mean(occ_acc)),
            "n_val": len(val)}


def past_flow_sanity(ckpt, data: Path, crop=(0, 0), cpu: bool = False) -> dict:
    """Linear motion: the soft model's past-flow head output should stay
    ~ equal to the future flow. The head's output is consumed with the
    negative multiplier ("past is left negative to copy weights of
    pretrained model", models/pwc.lua:438), so +future is exactly the
    negated past displacement the warp needs; the fine-tune starts there
    (convert_to_soft copies the future decoder) and, on linear-motion
    data, should keep it there rather than drift. Runs on the card
    unless `cpu`."""
    import torch

    from back2future_tpu_torch.config import Options
    from back2future_tpu_torch.data import FlowDataset, SampleConfig, load_manifest, load_split
    from back2future_tpu_torch.train.checkpoint import build_from_params, load_model_checkpoint

    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --cpu in --eval_args for the CPU)")
    device = torch.device("cpu" if cpu else "cuda")
    params, cfg = load_model_checkpoint(ckpt)
    assert cfg.past_flow, "stage-2 checkpoint should have past-flow heads"
    model = build_from_params(cfg, params).to(device).eval()

    opt = Options(dataset="RoamingImages", ground_truth=True,
                  frames=cfg.frames, levels=cfg.levels, rand_crop=0,
                  cropWidth=crop[0], cropHeight=crop[1]).derive()
    specs = load_manifest(data / "datasets" / "RoamingImages.dat",
                          ground_truth=True, root=str(data / "data"))
    _, val = load_split(data / "datasets" / "RoamingImages_split.dat")
    ds = FlowDataset(specs, SampleConfig.from_options(opt), val[:8], train=False)
    batch = ds.get(0, min(8, len(ds)))

    with torch.no_grad():
        g = model(torch.from_numpy(batch["images"]).to(device), with_warped=False)[0]
    fut = g["flow"].float().cpu().numpy()
    past = g["flow_past"].float().cpu().numpy()
    denom = float(np.mean(np.hypot(fut[..., 0], fut[..., 1]))) + 1e-8
    resid = float(np.mean(np.hypot(*(past - fut).transpose(3, 0, 1, 2))))
    corr = float(np.corrcoef(past.ravel(), fut.ravel())[0, 1])
    return {"mean_|past-future|_over_mean_|future|": resid / denom,
            "corr(past, future)": corr}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=str(_TMP / "roaming"))
    ap.add_argument("--out", default="docs/evidence/learning_demo_torch")
    ap.add_argument("--cache", default=str(_TMP / "learn_demo_ckpt"))
    ap.add_argument("--escape_data", default=str(_TMP / "roam_escape"),
                    help="tiny low-diversity roaming set for the stage-0 "
                         "saddle escape (data.roaming --n 10 --seed 1); "
                         "'none' skips the stage")
    ap.add_argument("--escape_epochs", type=int, default=2)
    ap.add_argument("--epochs1", type=int, default=20)
    ap.add_argument("--lr1", default="0.0003",
                    help="stage-1 LR. The reference default regime (1e-4 + "
                         "per-epoch Adam-moment reset, train.lua:66-92) is "
                         "tuned for multi-day KITTI runs; 3e-4 + persistent "
                         "moments learns at demo timescales, both via public "
                         "CLI flags.")
    ap.add_argument("--clip1", default="500",
                    help="stage-1 --grad_clip global norm (init grad norm "
                         "is ~420; unclipped 3e-4 diverged in the JAX "
                         "package's run). 0 disables.")
    ap.add_argument("--scene_batches", default="full",
                    help="stage-0/1 --scene_batches: 'full' (default) makes "
                         "batch composition deterministic — every batch "
                         "holds every scene (sets smaller than the batch) "
                         "or a round-robin scene sweep (larger sets). An "
                         "integer k draws each batch from k random scenes "
                         "(0 = reference-style uniform). Not applied to "
                         "stage 2.")
    ap.add_argument("--curriculum", default="30",
                    help="comma-separated intermediate scene counts "
                         "between the escape set and the full train set "
                         "(each level: first-K train scenes via a "
                         "restricted split, --curriculum_epochs each, "
                         "chained --retrain). '' skips straight to the "
                         "full set.")
    ap.add_argument("--curriculum_epochs", type=int, default=2)
    ap.add_argument("--epochs2", type=int, default=3)
    ap.add_argument("--epoch_size", type=int, default=250)
    ap.add_argument("--batch", type=int, default=16,
                    help="16 (not the reference's 8) so the 10-scene "
                         "escape set fits inside one batch — the "
                         "full-set deterministic-batch regime needs "
                         "batch >= n_escape_scenes")
    ap.add_argument("--wire", default="compact",
                    help="host->device wire (compact: u8/f16; f32 = "
                         "reference-parity pipeline)")
    ap.add_argument("--stage", default="all",
                    choices=["all", "escape", "hard", "soft", "eval"])
    ap.add_argument("--train_args", default="",
                    help="extra back2future_tpu_torch.main flags appended "
                         "to every stage (shlex-split), e.g. '--platform "
                         "cpu --levels 4 --cropWidth 64 --cropHeight 32' "
                         "for a tiny CPU run")
    ap.add_argument("--eval_args", default="",
                    help="extra back2future_tpu_torch.eval flags, e.g. '--cpu'")
    args = ap.parse_args(argv)

    data = Path(args.data)
    ds_dir = data / "datasets"
    if not (ds_dir / "RoamingImages.dat").exists():
        sys.exit(f"--data {data}: no datasets/RoamingImages.dat — generate "
                 f"with: python -m back2future_tpu_torch.data.roaming --out {data} --n 300")
    out = REPO / args.out
    out.mkdir(parents=True, exist_ok=True)
    cache = Path(args.cache)
    extra_train = shlex.split(args.train_args)
    extra_eval = shlex.split(args.eval_args)

    common = ["--dataset", "RoamingImages", "--datasets_dir", str(ds_dir),
              "--data_root", str(data / "data"), "--ground_truth", "1",
              "--cache", str(cache), "--batchSize", str(args.batch),
              "--epochSize", str(args.epoch_size), "--nDonkeys", "0",
              "--wire", args.wire, "--epochStore", "1",
              # rand_crop is a geometric no-op at the generator's full
              # resolution but consumes rng draws; 0 makes the train hook
              # deterministic so the loader's sample memo engages
              # (SampleConfig.deterministic) — epoch 2+ skip PNG decode
              "--rand_crop", "0"]

    escape_ckpt = cache / "escape" / f"model_{args.escape_epochs}.pt"
    hard_ckpt = cache / "hard" / f"model_{args.epochs1}.pt"
    soft_ckpt = cache / "soft" / f"model_{args.epochs2}.pt"
    use_escape = args.escape_data != "none" and args.escape_epochs > 0

    sb = ("1000000000" if args.scene_batches == "full"
          else str(int(args.scene_batches)))
    hard_recipe = ["--optimize", "pme", "--pme", "1",
                   "--pme_criterion", "OBCC", "--smooth_flow", "2",
                   "--LR", args.lr1, "--grad_clip", args.clip1,
                   "--adam_reset_per_epoch", "0",
                   "--scene_batches", sb]

    if use_escape and args.stage in ("all", "escape"):
        esc = Path(args.escape_data)
        if not (esc / "datasets" / "RoamingImages.dat").exists():
            # Generate the default escape set. A disjoint seed from the
            # main data matters: scenes are keyed rng((seed, s)), so a
            # same-seed escape set would duplicate (and thus leak) the
            # main set's first scenes into what stage 1 trains on before
            # the held-out eval.
            print(f"[stage0] escape set missing at {esc}; generating "
                  f"(data.roaming --n 10 --seed 1)", flush=True)
            from back2future_tpu_torch.data.roaming import main as make_roaming_main

            make_roaming_main(["--out", str(esc), "--n", "10", "--seed", "1"])
        esc_common = list(common)
        esc_common[esc_common.index("--datasets_dir") + 1] = str(esc / "datasets")
        esc_common[esc_common.index("--data_root") + 1] = str(esc / "data")
        run_cli(esc_common + hard_recipe +
                ["--expName", "escape",
                 "--nEpochs", str(args.escape_epochs)] + extra_train,
                "stage0-escape")

    if args.stage in ("all", "hard"):
        if use_escape and not escape_ckpt.exists():
            sys.exit(f"--stage hard: stage-0 checkpoint {escape_ckpt} not "
                     f"found. Run `--stage escape` first (same --cache and "
                     f"--escape_epochs), or pass `--escape_data none` to "
                     f"train from scratch (expect the zero-flow saddle: "
                     f"flat EPE for 1000+ steps on diverse data).")
        prev = escape_ckpt if use_escape else None
        # curriculum widening: intermediate levels of the main set's first
        # K train scenes (split-restricted — val rows untouched, so every
        # level evals the same held-out scenes; excluded scenes get split
        # value 0). Each widening starts from the previous level's fit.
        levels = [int(k) for k in args.curriculum.split(",") if k.strip()]
        for k in levels:
            cur_dir = cache / f"cur{k}" / "datasets"
            cur_dir.mkdir(parents=True, exist_ok=True)
            shutil.copy(ds_dir / "RoamingImages.dat", cur_dir / "RoamingImages.dat")
            vals = np.array([int(t) for t in
                             (ds_dir / "RoamingImages_split.dat").read_text().split()])
            sub = np.zeros_like(vals)
            sub[np.nonzero(vals == 1)[0][:k]] = 1
            sub[vals == 2] = 2
            (cur_dir / "RoamingImages_split.dat").write_text("\n".join(map(str, sub)) + "\n")
            cur_common = list(common)
            cur_common[cur_common.index("--datasets_dir") + 1] = str(cur_dir)
            run_cli(cur_common + hard_recipe +
                    (["--retrain", str(prev)] if prev else []) +
                    ["--expName", f"cur{k}",
                     "--nEpochs", str(args.curriculum_epochs)] + extra_train,
                    f"stage1-cur{k}")
            prev = cache / f"cur{k}" / f"model_{args.curriculum_epochs}.pt"
        run_cli(common + hard_recipe +
                (["--retrain", str(prev)] if prev else []) +
                ["--expName", "hard",
                 "--nEpochs", str(args.epochs1)] + extra_train,
                "stage1-hard")

    if args.stage in ("all", "soft"):
        if not hard_ckpt.exists():
            sys.exit(f"--stage soft: stage-1 checkpoint {hard_ckpt} not "
                     f"found. Run `--stage hard` first (same --cache and "
                     f"--epochs1).")
        run_cli(common + ["--expName", "soft", "--optimize", "pme",
                          "--retrain", str(hard_ckpt),
                          "--convert_to_soft", "1", "--past_flow", "1",
                          "--pme", "4", "--pme_criterion", "OBGCC",
                          "--pme_alpha", "1", "--pme_beta", "0",
                          "--pme_gamma", "0", "--smooth_flow", "0.1",
                          "--smooth_second_order", "1",
                          "--const_vel", "0.0001", "--LR", "0.00001",
                          "--grad_clip", args.clip1,
                          "--adam_reset_per_epoch", "0",
                          "--nEpochs", str(args.epochs2)] + extra_train,
                "stage2-soft")

    if args.stage == "escape":
        print("\n[stage0] done; run --stage hard (or all) next. No report "
              "written for a standalone escape stage.", flush=True)
        return

    # ---- report: copy logs first, then evals (all non-fatal) ----
    for exp in ("escape", "hard", "soft"):
        for f in ("train.log", "test.log", "log"):
            src = cache / exp / f
            if src.exists():
                name = f.replace(".log", ".tsv") if f != "log" else "console.txt"
                shutil.copy(src, out / f"{exp}_{name}")
        for f in (cache / exp).glob("*.svg"):
            shutil.copy(f, out / f"{exp}_{f.name}")

    report = {"dataset": str(data),
              "escape": {"data": args.escape_data,
                         "epochs": args.escape_epochs} if use_escape else None,
              "epochs": [args.epochs1, args.epochs2],
              "epoch_size": args.epoch_size, "batch": args.batch,
              "lr1": args.lr1, "grad_clip": args.clip1, "wire": args.wire,
              "train_args": args.train_args}
    try:
        report["baseline"] = zero_flow_baseline(data)
    except Exception as e:  # noqa: BLE001 — report must still be written
        report["baseline"] = {"error": repr(e)}
    if use_escape and escape_ckpt.exists():
        # transfer probe: the stage-0 escape checkpoint on the unseen
        # main-set val split, before/independent of any wide training —
        # distinguishes a real escape (matching features, transfers)
        # from per-scene constant-flow memorization (doesn't).
        report["eval_escape_transfer"] = run_eval(
            escape_ckpt, data, "escape_transfer", args.batch, extra_eval)
    report["eval_hard"] = run_eval(hard_ckpt, data, "hard", args.batch, extra_eval)
    report["eval_soft"] = run_eval(soft_ckpt, data, "soft", args.batch, extra_eval)
    if soft_ckpt.exists():
        print("\n=== past-flow sanity ===", flush=True)
        # honour an eval-time crop override (tiny CPU runs)
        crop = [0, 0]
        for i, flag in enumerate(extra_eval):
            if flag == "--cropWidth":
                crop[0] = int(extra_eval[i + 1])
            elif flag == "--cropHeight":
                crop[1] = int(extra_eval[i + 1])
        try:
            report["past_flow_sanity"] = past_flow_sanity(
                soft_ckpt, data, tuple(crop), cpu="--cpu" in extra_eval)
        except Exception as e:  # noqa: BLE001
            report["past_flow_sanity"] = {"error": repr(e)}
        print(report["past_flow_sanity"], flush=True)

    (out / "learning_demo.json").write_text(json.dumps(report, indent=2))
    print(f"\nwrote {out / 'learning_demo.json'}", flush=True)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
