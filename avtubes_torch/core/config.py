"""One dataclass config tree shared by every entry point of the port.

The port's own copy of `avtubes/core/config.py`: the same tree and the same
command-line flags, flag for flag, plus `--device` (default ``cuda``; the
entry points raise without a card unless ``--device cpu`` is asked for).
Flags whose code is not ported yet parse and are carried in the tree, as
they are in the JAX package for an entry point that does not read them.
"""

from __future__ import annotations

import argparse
import dataclasses

from avtubes_torch.core.device import DEFAULT_DEVICE
from avtubes_torch.models.hardway import HardwayConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    testset: str = "flickr"            # 'flickr' | 'vggss'
    data_path: str = ""                # root with videos/<id>/{0..15}.jpg + audio/<id>.wav
    og_data_path: str = ""             # root with frames/<id>.jpg + audio/<id>.wav (hardway test)
    gt_path: str = ""                  # per-frame XML dir
    og_gt_path: str = ""               # whole-video XML dir
    metadata_dir: str = "metadata"     # CSV/JSON index dir
    image_size: int = 224
    frame_density: int = 16            # frames per training clip (1 = middle frame only)
    sampling_rate: int = 16            # eval frame stride
    subset: int = 10                   # flickr train subset in thousands {5,10,20,144}
    samplerate: int = 22050
    audio_seconds: int = 10
    n_threads: int = 5                 # host decode workers
    clip_decode_threads: int = 1       # intra-clip threads of the fused C++
                                       # clip decode; raise on many-core
                                       # hosts when n_threads alone doesn't
                                       # saturate (threads multiply!)
    audio_transport: str = "int16"     # what the host ships to the device:
                                       # 'float32' raw waveform; 'int16' PCM
                                       #   waveform (lossless for 16-bit
                                       #   sources, halves audio H2D);
                                       # 'spec_int16' host-computed log-
                                       #   spectrogram, int16 fixed-point
                                       #   (halves audio bytes again, ~3e-5
                                       #   quantization) — for thin
                                       #   host->device links;
                                       # 'spec_int8' OPT-IN int8 spectrogram
                                       #   (halves spec bytes again, ~8e-3
                                       #   quantization — NOT parity-grade)

    prefetch: int = 2                  # device prefetch depth
    eval_batch_size: int = 32          # hard-way eval batch (per-sample
                                       # independent + padded, so any value
                                       # is numerically identical; bigger
                                       # batches amortize device dispatch)
    synthetic: bool = False            # generated data (tests / smoke)

    @property
    def audio_int16(self) -> bool:     # back-compat alias
        return self.audio_transport == "int16"


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 4e-6
    weight_decay: float = 1e-4         # torch-Adam style L2 (added to grads pre-moments)
    lr_milestones: tuple[int, ...] = (60, 100, 150, 180)  # epochs
    lr_gamma: float = 0.1
    epochs: int = 20
    batch_size: int = 20
    loss_weight: float = 0.1           # hardway CE weight; consistency gets (100 - w)
    epoch_threshold: int = 10


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    summaries_dir: str = "checkpoints/"
    seed: int = 0
    compute_dtype: str = "bfloat16"    # backbone compute dtype ('float32'|'bfloat16')
    negative_pool: str = "global"      # 'global' | 'device' (DataParallel parity)
    log_every: int = 10
    watch_every: int = 0               # log per-layer grad/param norms every N
    #                                    steps (wandb.watch log_freq parity;
    #                                    0 = off; reference uses 1000)
    group_steps: int = 1               # optimizer steps fused per dispatch
    #                                    (carried; the port runs eagerly)
    remat: bool = False                # rematerialize backbones in backward
    checkpoint_every_epochs: int = 1
    record_qualitative: int = 0        # dump overlay JPEGs for first N eval videos
    use_pretrained: bool = False
    pretrained_path: str = ""
    steps_cap: int = 0                 # cap steps/epoch (0 = full epoch)
    jitter_order: str = "random"       # 'random' = torchvision per-sample op
    #                                    order parity; 'fixed' = static
    #                                    b->c->s->h order
    device: str = DEFAULT_DEVICE       # torch device of the run; 'cuda' raises
    #                                    without a card, 'cpu' must be asked for
    conv3d_impl: str = "direct"        # tube-encoder conv3d lowering of the
    #                                    JAX package ('direct' | 'stacked' |
    #                                    'sum'); carried, the port has
    #                                    `nn.Conv3d` only
    video_arch: str = "r3d18"          # the 3D trainer's tube encoder
    #                                    ('r3d18' | 'timesformer_b16' | 'swin3d_b')


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = DataConfig()
    optim: OptimConfig = OptimConfig()
    train: TrainConfig = TrainConfig()
    hardway: HardwayConfig = HardwayConfig()

    @classmethod
    def from_args(cls, argv: list[str] | None = None) -> "ExperimentConfig":
        """Parse the reference-compatible CLI flag set into the config tree."""
        p = argparse.ArgumentParser()
        p.add_argument("--testset", default="flickr", type=str)
        p.add_argument("--data_path", default="", type=str)
        p.add_argument("--og_data_path", default="", type=str)
        p.add_argument("--image_size", default=224, type=int)
        p.add_argument("--gt_path", default="", type=str)
        p.add_argument("--og_gt_path", default="", type=str)
        p.add_argument("--metadata_dir", default="metadata", type=str)
        p.add_argument("--summaries_dir", default="checkpoints/", type=str)
        p.add_argument("--batch_size", default=20, type=int)
        p.add_argument("--epsilon", default=0.65, type=float)
        p.add_argument("--epsilon2", default=0.4, type=float)
        p.add_argument("--tri_map", action="store_true", default=True)
        p.add_argument("--Neg", action="store_true", default=True)
        p.add_argument("--learning_rate", default=4e-6, type=float)
        p.add_argument("--weight_decay", default=1e-4, type=float)
        p.add_argument("--n_threads", default=5, type=int)
        p.add_argument("--clip_decode_threads", default=1, type=int,
                       help="intra-clip threads of the fused C++ clip decode "
                            "(many-core hosts; multiplies with --n_threads)")
        p.add_argument("--epochs", default=20, type=int)
        p.add_argument("--frame_density", default=16, type=int)
        p.add_argument("--sampling_rate", default=16, type=int)
        p.add_argument("--loss_weight", default=0.1, type=float)
        # store_true, NOT type=bool: `--use_pretrained False` would parse
        # as True under type=bool (any non-empty string is truthy)
        p.add_argument("--use_pretrained", action="store_true", default=False)
        p.add_argument("--pretrained_path", default="", type=str)
        p.add_argument("--epoch_threshold", default=10, type=int)
        # flags the reference scripts did not have
        p.add_argument("--subset", default=10, type=int)
        p.add_argument("--samplerate", default=22050, type=int)
        p.add_argument("--audio_seconds", default=10, type=int)
        p.add_argument("--seed", default=0, type=int)
        p.add_argument("--compute_dtype", default="bfloat16", type=str)
        p.add_argument("--negative_pool", default="global", type=str)
        p.add_argument("--synthetic", action="store_true", default=False)
        p.add_argument("--group_steps", default=1, type=int)
        p.add_argument("--remat", action="store_true", default=False)
        p.add_argument("--record_qualitative", default=0, type=int,
                       help="dump overlay JPEGs for the first N eval videos")
        p.add_argument("--steps", default=0, type=int, help="cap steps/epoch (0 = full)")
        p.add_argument("--watch_every", default=0, type=int,
                       help="log per-layer grad/param norms every N steps "
                            "(wandb.watch parity; 0 = off)")
        p.add_argument("--eval_batch_size", default=32, type=int)
        p.add_argument("--jitter_order", default="random", type=str,
                       choices=["random", "fixed"],
                       help="color-jitter op order: 'random' per sample "
                            "(torchvision parity) or 'fixed' static")
        p.add_argument("--conv3d_impl", default="direct", type=str,
                       choices=["direct", "stacked", "sum"],
                       help="tube-encoder conv3d lowering of the JAX package "
                            "(3D trainer only; carried, not read by the port)")
        p.add_argument("--video_arch", default="r3d18", type=str,
                       help="the 3D trainer's tube encoder: 'r3d18', "
                            "'timesformer_b16' (TimeSformer-B/16, divided "
                            "space-time attention) or 'swin3d_b' (Video "
                            "Swin-B, 3-D shifted-window attention), the "
                            "transformers over clips of --frame_density "
                            "frames at --image_size")
        p.add_argument("--audio_transport", default="int16", type=str,
                       choices=["float32", "int16", "spec_int16", "spec_int8"],
                       help="audio payload: raw f32, int16 PCM (lossless for "
                            "16-bit sources), host-computed int16 "
                            "log-spectrogram (thin-link mode), or opt-in "
                            "int8 spectrogram (thinnest links; ~8e-3 "
                            "quantization — validate metrics first)")
        p.add_argument("--device", default=DEFAULT_DEVICE, type=str,
                       help="torch device; 'cuda' (default) raises without a "
                            "card, 'cpu' must be asked for")
        a = p.parse_args(argv)
        cfg = cls(
            data=DataConfig(
                testset=a.testset, data_path=a.data_path, og_data_path=a.og_data_path,
                gt_path=a.gt_path, og_gt_path=a.og_gt_path, metadata_dir=a.metadata_dir,
                image_size=a.image_size, frame_density=a.frame_density,
                sampling_rate=a.sampling_rate, subset=a.subset, n_threads=a.n_threads,
                clip_decode_threads=a.clip_decode_threads,
                samplerate=a.samplerate, audio_seconds=a.audio_seconds,
                audio_transport=a.audio_transport, synthetic=a.synthetic,
                eval_batch_size=a.eval_batch_size,
            ),
            optim=OptimConfig(
                learning_rate=a.learning_rate, weight_decay=a.weight_decay,
                epochs=a.epochs, batch_size=a.batch_size, loss_weight=a.loss_weight,
                epoch_threshold=a.epoch_threshold,
            ),
            train=TrainConfig(
                summaries_dir=a.summaries_dir, seed=a.seed,
                compute_dtype=a.compute_dtype, negative_pool=a.negative_pool,
                use_pretrained=a.use_pretrained, pretrained_path=a.pretrained_path,
                group_steps=a.group_steps, watch_every=a.watch_every,
                steps_cap=a.steps, remat=a.remat,
                record_qualitative=a.record_qualitative,
                jitter_order=a.jitter_order, conv3d_impl=a.conv3d_impl,
                video_arch=a.video_arch, device=a.device,
            ),
            hardway=HardwayConfig(
                epsilon=a.epsilon, epsilon2=a.epsilon2, trimap=a.tri_map, use_neg=a.Neg,
            ),
        )
        return cfg
