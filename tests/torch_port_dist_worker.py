"""One rank of the port's 2-process data-parallel checks, and the
one-process runs they are held to (tests/test_torch_port_distributed.py).

    python tests/torch_port_dist_worker.py OUT_DIR [step]
    python tests/torch_port_dist_worker.py OUT_DIR trainer DATA_YAML

with the torchrun variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE=2, RANK)
set; `parallel.distributed.initialize()` joins a gloo group.

- `step`: an all-reduce of the ranks' numbers, then one training step of
  `parallel.mesh.make_sharded_train_step` on the global batch-2 clip; the
  rank's gradients, BatchNorm statistics and metrics go to
  OUT_DIR/rank{RANK}.pt. `one_process_step()` is the same step on the
  whole batch in one process.
- `trainer`: `min_over_ranks` of 4 and 2; `MOTRTrack.train` with a batch
  of 3, which two ranks cannot split; then `train_run` with `batch=-1`
  and each rank's one-card probe patched to answer AUTOBATCH_PER_CARD[rank]
  (the global batch is the smallest answer times the ranks: 2), counting
  the sharded step's gradient sums over the ranks, and a resume of its
  `last_full`. Every path the rank opened for writing, created or renamed
  under OUT_DIR/runs is recorded (`chip_smoke.record_writes`, an audit
  hook). The record goes to OUT_DIR/trainer{RANK}.pt. `train_run` at
  batch 2 in one process is the reference.

Imports no JAX."""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
TINY_YAML = str(ROOT / "tests" / "tiny_track.yaml")
# tiny_track at 64x64: nq is every valid anchor (84), so the detect-query
# selection is a permutation and does not hang on top-k's near-ties; CDN,
# track dropout and FP injection on, so that each rank must take its rows
# of the global batch's noise
T, B, G, HW = 2, 2, 5, 64
MODEL_KW = dict(nq=84, hd=32, ndl=2, d_ffn=32, num_denoising=8)
# the trainer's run: one epoch of the fixture's 4 clips at batch 2 (2
# steps), validation on the last sequence at the epoch's end and of `best`
# at the end, every step logged
TRAIN_KW = dict(epochs=1, clip_len=T, max_gt=G, log_every=1)
AUTOBATCH_PER_CARD = (1, 3)
FIXTURE_SEQS, FIXTURE_FRAMES, FIXTURE_OBJECTS = 2, 4, 3


def _clip():
    """Two 2-frame clips of four moving boxes; the last GT row is padding,
    and the second clip has a third padded row."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (T, B, HW, HW, 3)).astype(np.uint8)
    ids = np.tile(np.array([0, 1, 2, 3, 0], np.int32), (T, B, 1))
    mask = np.ones((T, B, G), bool)
    mask[:, :, 4] = False
    mask[:, 1, 3] = False
    boxes = np.zeros((T, B, G, 4), np.float32)
    for b in range(B):
        base = rng.uniform(0.25, 0.75, (G, 2))
        for t in range(T):
            c = base + 0.03 * t
            boxes[t, b, :, :2] = c
            boxes[t, b, :, 2:] = [0.2, 0.25]
            for g in range(4):
                y, x = (c[g] * HW).astype(int)[::-1]
                imgs[t, b, y - 4:y + 4, x - 4:x + 4] = 255
    clip = {"images": imgs, "gt_cls": ids % 3, "gt_boxes": boxes,
            "gt_track_id": ids, "gt_mask": mask}
    return {k: torch.from_numpy(v) for k, v in clip.items()}


def _step(make, device="cpu"):
    """One step of `make(model, lcfg, tcfg)`'s (init_fn, step_fn) from
    seeded weights and random BatchNorm statistics, on `device`: its
    gradients, running statistics and metrics."""
    from mo_yolo_tpu_torch.models.tracker import TrackerConfig
    from mo_yolo_tpu_torch.models.tracking_model import build_tracking_model
    from mo_yolo_tpu_torch.train.losses import LossConfig
    from mo_yolo_tpu_torch.train.train_step import TrainConfig
    torch.manual_seed(0)
    model = build_tracking_model(TINY_YAML, device=device, seed=0,
                                 tracker=TrackerConfig(n_slots=8), **MODEL_KW)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features,
                                                 generator=g) * 0.2)
                m.running_var.copy_(torch.rand(m.num_features,
                                               generator=g) + 0.5)
    tcfg = TrainConfig(clip_len=T, warmup_steps=2, total_steps=10)
    init_fn, step_fn = make(model, LossConfig(nc=model.spec.nc), tcfg)
    ts = init_fn()
    clip = {k: v.to(device) for k, v in _clip().items()}
    ts, metrics = step_fn(ts, clip,
                          torch.Generator(device=device).manual_seed(2))
    return {"grads": _grads(model),
            "stats": {n: b.detach().clone() for n, b in model.named_buffers()
                      if "running" in n},
            "metrics": {k: torch.as_tensor(v).detach().clone()
                        for k, v in metrics.items()}}


def _grads(model):
    """Every parameter's gradient; a parameter without one has a zero one
    (the sharded step sets it so for its collective)."""
    return {n: torch.zeros_like(p) if p.grad is None
            else p.grad.detach().clone() for n, p in model.named_parameters()}


def one_process_step():
    from mo_yolo_tpu_torch.train.train_step import make_train_step
    return _step(make_train_step)


# ------------------------------------------------------------- the trainer

def write_fixture(root) -> str:
    """FIXTURE_SEQS sequences of FIXTURE_FRAMES 64x64 frames, each with
    FIXTURE_OBJECTS boxes of 14-22 px moving a few pixels a frame, in the
    MOT-challenge layout, converted by the port's `convert_mot_to_yolo`
    (the last sequence doubles as val). Returns the dataset yaml."""
    from mo_yolo_tpu_torch.data.encode import write_image
    from mo_yolo_tpu_torch.data.mot_challenge import (convert_mot_to_yolo,
                                                      write_mot_gt)
    root = Path(root)
    for s in range(FIXTURE_SEQS):
        rng = np.random.default_rng(10 + s)
        seq = root / "raw" / "images" / "train" / f"MOT17-{s + 1:02d}"
        (seq / "img1").mkdir(parents=True)
        size = rng.integers(14, 23, (FIXTURE_OBJECTS, 2))
        start = rng.integers(4, HW - 30, (FIXTURE_OBJECTS, 2))
        vel = rng.integers(-3, 4, (FIXTURE_OBJECTS, 2))
        colour = rng.integers(0, 256, (FIXTURE_OBJECTS, 3))
        rows = []
        for t in range(FIXTURE_FRAMES):
            img = rng.integers(0, 40, (HW, HW, 3)).astype(np.uint8)
            for k in range(FIXTURE_OBJECTS):
                x0, y0 = np.clip(start[k] + t * vel[k], 0, HW - size[k] - 1)
                w, h = size[k]
                img[y0:y0 + h, x0:x0 + w] = colour[k]
                rows.append([t + 1, k + 1, x0, y0, w, h, 1, 1, 1.0])
            write_image(seq / "img1" / f"{t + 1:06d}.png", img)
        write_mot_gt(str(seq / "gt" / "gt.txt"), rows)
        (seq / "seqinfo.ini").write_text(
            f"[Sequence]\nname={seq.name}\nimDir=img1\nframeRate=30\n"
            f"seqLength={FIXTURE_FRAMES}\nimWidth={HW}\nimHeight={HW}\n"
            f"imExt=.png\n")
    return convert_mot_to_yolo(str(root / "raw"), str(root / "yolo"))


def quiet_settings(config_dir) -> str:
    """A settings file with every logger integration off (the JSONL logger
    stays: it is not a setting); its directory, for
    MO_YOLO_TPU_TORCH_CONFIG_DIR."""
    from mo_yolo_tpu_torch.utils.settings import Settings
    config_dir = Path(config_dir)
    st = Settings(config_dir / "settings.yaml")
    st.update({k: False for k in ("tensorboard", "mlflow", "wandb", "comet",
                                  "clearml", "neptune", "dvc", "raytune")})
    st.save()
    return str(config_dir)


def tracker():
    from mo_yolo_tpu_torch import MOTRTrack
    from mo_yolo_tpu_torch.models.tracker import TrackerConfig
    return MOTRTrack("tiny_track", imgsz=HW, dtype="float32", device="cpu",
                     tracker=TrackerConfig(n_slots=8), **MODEL_KW)


def state_of(ts):
    """A TrainState's tensors by name (chip_smoke.state_tensors), cloned."""
    from chip_smoke import state_tensors
    return {k: v.detach().clone() for k, v in state_tensors(ts).items()}


def train_run(data_yaml, save_dir, batch=B, resume=False):
    """`MOTRTrack.train` of the tiny tracker: each step's metrics and
    gradients, the trainer's batch and steps an epoch, its final state
    (`state_of`) and the metrics it returns."""
    t = tracker()
    steps, seen = [], {}

    def on_start(trainer=None, **kw):
        seen["trainer"] = trainer

    def on_batch_end(trainer=None, metrics=None, **kw):
        steps.append({"metrics": {k: torch.as_tensor(v).detach().clone()
                                  for k, v in metrics.items()},
                      "grads": _grads(trainer.train_state.model)})
    t.callbacks.add("on_train_start", on_start)
    t.callbacks.add("on_train_batch_end", on_batch_end)
    out = t.train(str(data_yaml), save_dir=str(save_dir), batch=batch,
                  resume=resume, **TRAIN_KW)
    trainer = seen["trainer"]
    return {"steps": steps, "batch": trainer.batch,
            "steps_per_epoch": trainer.steps_per_epoch,
            "state": state_of(trainer.train_state),
            "metrics": {k: float(v) for k, v in out.items()}}


def trainer_main(out: Path, data_yaml: str, world) -> dict:
    from chip_smoke import record_writes
    from mo_yolo_tpu_torch.parallel import distributed as D
    from mo_yolo_tpu_torch.train.trainer import TrackTrainer
    rec = {"world": tuple(world),
           "min_over_ranks": D.min_over_ranks((4, 2)[world.rank])}
    writes = []
    record_writes(out / "runs", writes)
    try:
        tracker().train(data_yaml, save_dir=str(out / "runs" / "batch3"),
                        batch=3, **TRAIN_KW)
        rec["indivisible"] = None
    except ValueError as e:
        rec["indivisible"] = str(e)
    TrackTrainer._autobatch = \
        lambda self, *a, **k: AUTOBATCH_PER_CARD[world.rank]
    summed, reduce_grads = [], D.all_reduce_grads

    def counted(params):
        summed.append(1)
        reduce_grads(params)
    D.all_reduce_grads = counted
    rec["run"] = train_run(data_yaml, out / "runs" / "run", batch=-1)
    D.all_reduce_grads = reduce_grads
    rec["gradient_sums"] = len(summed)
    rec["resumed"] = train_run(data_yaml, out / "runs" / "run", resume=True)
    rec["writes"] = writes
    return rec


def main() -> None:
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from mo_yolo_tpu_torch.parallel import distributed as D
    from mo_yolo_tpu_torch.parallel.mesh import make_sharded_train_step
    out = Path(sys.argv[1])
    mode = sys.argv[2] if len(sys.argv) > 2 else "step"
    assert D.initialize() is True, "initialize() under WORLD_SIZE=2"
    world = D.global_mesh()
    assert world.size == 2 and dist.get_backend() == "gloo", world
    if mode == "trainer":
        rec = trainer_main(out, sys.argv[3], world)
        torch.save(rec, out / f"trainer{world.rank}.pt")
    else:
        x = torch.tensor([float(world.rank + 1)])
        dist.all_reduce(x)
        assert float(x) == 3.0, float(x)
        rec = _step(make_sharded_train_step)
        rec["world"] = tuple(world)
        rec["all_reduce"] = float(x)
        torch.save(rec, out / f"rank{world.rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
