"""TrackingModel — backbone/neck + TrackDecoder + tracker, one frame per
`stream_step` in inference and per `train_frame` in training (counterpart
of `mo_yolo_tpu/models/tracking_model.py`).

The module tree reproduces upstream's `state_dict` layout: `model.{i}` for
the graph rows and `model.{head}` for the head, which holds `decoder`
(the TrackDecoder) and `track_embed` (the QIM).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from mo_yolo_tpu_torch.models.decoder import TrackDecoder
from mo_yolo_tpu_torch.models.graph import (BackboneNeck, GraphSpec,
                                            parse_model_yaml)
from mo_yolo_tpu_torch.models.layers import MultiHeadSelfAttention
from mo_yolo_tpu_torch.models.tracker import (QIM, TrackerConfig, TrackState,
                                              init_track_state,
                                              inject_fp_tracks, pack_outputs,
                                              random_drop_tracks,
                                              runtime_update,
                                              track_train_assign,
                                              train_update)
from mo_yolo_tpu_torch.models.transformer import offset_bias_init
from mo_yolo_tpu_torch.ops.denoising import (CDNNoise,
                                             build_cdn_group_from_noise,
                                             draw_cdn_noise)
from mo_yolo_tpu_torch.utils.device import resolve_device, resolve_dtype


class MOTRTrackHead(nn.Module):
    """The head row's module: `decoder` and `track_embed` (QIM)."""

    def __init__(self, in_channels, nc: int, hd: int = 256, nq: int = 300,
                 ndl: int = 6, d_ffn: int = 1024, impl: Optional[str] = None):
        super().__init__()
        self.decoder = TrackDecoder(in_channels, nc=nc, hd=hd, nq=nq, ndl=ndl,
                                    d_ffn=d_ffn, impl=impl)
        self.track_embed = QIM(d_model=hd, d_ffn=hd)


class FrameNoise(NamedTuple):
    """The random numbers of one training frame, drawn before the frame
    runs, so that a checkpointed frame recomputes with the same ones."""
    cdn: Optional[CDNNoise]   # None when CDN is off
    drop: torch.Tensor        # [B,N] uniform: track dropout
    fp: torch.Tensor          # [B,N] uniform: false-positive injection


class TrackingModel(nn.Module):
    def __init__(self, spec: GraphSpec, tracker: TrackerConfig = TrackerConfig(),
                 hd: int = 256, nq: int = 300, ndl: int = 6,
                 d_ffn: int = 1024, num_denoising: int = 100,
                 impl: Optional[str] = None):
        super().__init__()
        self.spec, self.tracker, self.hd = spec, tracker, hd
        self.nq, self.num_denoising = nq, num_denoising
        head = MOTRTrackHead(spec.out_channels, spec.nc, hd, nq, ndl, d_ffn,
                             impl=impl)
        self.model = BackboneNeck(spec, head)

    @property
    def head(self) -> MOTRTrackHead:
        return self.model[self.spec.head_index]

    @property
    def decoder(self) -> TrackDecoder:
        return self.head.decoder

    def init_state(self, batch: int = 1) -> TrackState:
        return init_track_state(batch, self.tracker.n_slots, self.hd,
                                device=next(self.parameters()).device)

    def frame_forward(self, images: torch.Tensor, state: TrackState,
                      dn_cls=None, dn_bbox_logit=None, dn_attn_mask=None,
                      train: bool = False
                      ) -> Tuple[Dict[str, Any], Tuple[torch.Tensor, ...]]:
        """Raw decoder outputs for one frame. images [B,H,W,3]: raw uint8
        (normalised in the stem) or float in [0, 1]. FP tracks (obj_id -2)
        take part as queries."""
        feats = self.model(images)
        out = self.head.decoder(
            feats, track_query_pos=state.query_pos,
            track_ref_logit=state.ref_logit, track_cls=state.cls.long(),
            track_mask=state.obj_id != -1, dn_cls=dn_cls,
            dn_bbox_logit=dn_bbox_logit, dn_attn_mask=dn_attn_mask,
            train=train)
        return out, feats

    def draw_frame_noise(self, generator: torch.Generator, batch: int,
                         max_gt: int) -> FrameNoise:
        """One training frame's noise from `generator`, on the model's
        device: the CDN noise (when CDN is on), then the dropout and the
        FP-injection uniforms."""
        dev = next(self.parameters()).device
        N = self.tracker.n_slots
        cdn = None
        if self.num_denoising > 0:
            cdn = draw_cdn_noise(generator, batch, max_gt, self.spec.nc,
                                 self.num_denoising, device=dev)

        def u():
            return torch.rand(batch, N, generator=generator,
                              device=generator.device).to(dev)
        return FrameNoise(cdn=cdn, drop=u(), fp=u())

    def train_frame(self, images: torch.Tensor, state: TrackState,
                    gt_cls: torch.Tensor, gt_boxes: torch.Tensor,
                    gt_track_id: torch.Tensor, gt_mask: torch.Tensor,
                    noise: FrameNoise, drop_prob: float = 0.1,
                    fp_ratio: float = 0.3
                    ) -> Tuple[TrackState, Dict[str, Any]]:
        """One training frame: CDN build -> decoder (train form) -> track /
        GT association -> teacher-forced state propagation, track dropout
        and FP injection -> QIM refresh (JAX `tracking_model.py:126-214`).

        gt_* are padded per-frame targets: gt_cls/gt_track_id [B,G] int,
        gt_boxes [B,G,4] cxcywh in [0,1], gt_mask [B,G] bool. Call it with
        the module in training mode. Returns (new_state, outs): everything
        the loss needs, in f32."""
        N = self.tracker.n_slots
        n_dn, num_group, dn = 0, 0, {}
        if self.num_denoising > 0:
            cdn = build_cdn_group_from_noise(
                noise.cdn, gt_cls, gt_boxes, n_main=N + self.nq,
                num_denoising=self.num_denoising)
            n_dn, num_group = cdn.num_dn, cdn.num_group
            dn = {"dn_cls": cdn.dn_cls, "dn_bbox_logit": cdn.dn_bbox_logit,
                  "dn_attn_mask": cdn.attn_mask}
        out, _ = self.frame_forward(images, state, train=True, **dn)
        boxes, logits = out["dec_bboxes"], out["dec_scores"]  # [L,B,Qt,...]
        dn_boxes, main_boxes = boxes[:, :, :n_dn], boxes[:, :, n_dn:]
        dn_logits, main_logits = logits[:, :, :n_dn], logits[:, :, n_dn:]

        det_boxes = main_boxes[-1][:, N:]
        det_logits = main_logits[-1][:, N:]
        assign, _ = track_train_assign(state.obj_id, gt_track_id, gt_mask,
                                       det_boxes, det_logits, gt_boxes,
                                       gt_cls)

        # the tracker state stays f32 under autocast
        embed = out["embed"][:, n_dn:].float()
        qpos = out["query_pos"][:, n_dn:].float()
        last_logits = main_logits[-1].float()
        comb_score = torch.sigmoid(last_logits).amax(-1)
        comb_cls = last_logits.argmax(-1).to(torch.int32)
        new_state = train_update(state, self.tracker, assign, gt_track_id,
                                 gt_mask, main_boxes[-1].float(), embed, qpos,
                                 comb_score, comb_cls)
        new_state = random_drop_tracks(new_state, drop_prob, noise.drop)
        new_state = inject_fp_tracks(new_state, det_boxes.detach().float(),
                                     embed[:, N:], qpos[:, N:], noise.fp,
                                     fp_ratio=fp_ratio)
        emb = self.head.track_embed(new_state.embedding, new_state.query_pos,
                                    new_state.obj_id != -1)
        new_state = new_state._replace(embedding=emb.float())
        outs = {
            "main_boxes": main_boxes.float(), "main_logits": main_logits.float(),
            "dn_boxes": dn_boxes.float(), "dn_logits": dn_logits.float(),
            "enc_boxes": out["enc_bboxes"].float(),
            "enc_logits": out["enc_scores"].float(),
            "assign": assign, "num_dn_group": num_group,
            # the main layer's rows that were real queries this frame:
            # active and FP track slots, and every detect query
            "query_valid": torch.cat(
                [state.obj_id != -1,
                 torch.ones(images.shape[0], self.nq, dtype=torch.bool,
                            device=images.device)], 1),
        }
        return new_state, outs

    @torch.no_grad()
    def stream_step(self, state: TrackState, images: torch.Tensor
                    ) -> Tuple[TrackState, torch.Tensor]:
        """One inference frame: decoder -> ID lifecycle -> QIM refresh.

        Returns (new_state, outputs [B,M,8]): the combined [track | detect]
        rows packed as (box cxcywh | score | cls | obj_id | valid); unpack
        on the host with `models.tracker.unpack_outputs`."""
        out, _ = self.frame_forward(images, state)
        N = self.tracker.n_slots
        # the tracker state stays f32 when the network computes in bf16
        boxes = out["dec_bboxes"][-1].float()
        logits = out["dec_scores"][-1].float()
        scores = torch.sigmoid(logits).max(-1).values
        cls = logits.argmax(-1).to(torch.int32)
        embed = out["embed"].float()
        qpos = out["query_pos"].float()
        parts = {"box": boxes, "score": scores, "cls": cls, "embed": embed,
                 "query_pos": qpos}
        track_out = {k: v[:, :N] for k, v in parts.items()}
        det_out = {k: v[:, N:] for k, v in parts.items()}
        new_state, outputs = runtime_update(state, self.tracker, track_out,
                                            det_out)
        emb = self.head.track_embed(new_state.embedding, new_state.query_pos,
                                    new_state.obj_id >= 0)
        return new_state._replace(embedding=emb), pack_outputs(outputs)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init of a tracking, detection or task model, following
    the JAX package's initialisers: LeCun-normal weights, zero biases,
    identity BatchNorm/LayerNorm, the upstream sampling-offset ring, zero
    attention-weight projections and the class prior on every score
    head."""
    def normal_(t: torch.Tensor, std: float):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            # a transposed conv's weight is [in, out, k, k]
            fan_in = m.weight[:, 0].numel() if isinstance(
                m, nn.ConvTranspose2d) else m.weight[0].numel()
            normal_(m.weight, fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 1.0)
        elif isinstance(m, MultiHeadSelfAttention):
            normal_(m.in_proj_weight, m.in_proj_weight.shape[1] ** -0.5)
            m.in_proj_bias.zero_()
    dec = getattr(model, "decoder", None)
    if dec is None:              # a YOLOv8 task model: no decoder
        return
    for layer in dec.decoder.layers:
        ca = layer.cross_attn
        ca.sampling_offsets.weight.zero_()
        ca.sampling_offsets.bias.copy_(
            offset_bias_init(ca.n_heads, ca.n_levels, ca.n_points))
        ca.attention_weights.weight.zero_()
        ca.attention_weights.bias.zero_()
    for head in [dec.enc_score_head, *dec.dec_score_head]:
        head.bias.fill_(dec.cls_bias_prior)


def build_tracking_model(cfg: Union[str, Dict[str, Any]] = "yolo_track",
                         nc: Optional[int] = None,
                         dtype: Union[str, torch.dtype] = torch.float32,
                         device=None, tracker: Optional[TrackerConfig] = None,
                         nq: Optional[int] = None, seed: int = 0,
                         impl: Optional[str] = None, hd: Optional[int] = None,
                         ndl: Optional[int] = None,
                         d_ffn: Optional[int] = None,
                         num_denoising: Optional[int] = None
                         ) -> TrackingModel:
    """Build the tracking model from a config (bundled name, dict or yaml
    path) with seeded random weights, in eval mode on `device` (None means
    the card; raises without one) in `dtype` (float32 or bfloat16).

    `impl="torch"` makes the decoder sample with the plain PyTorch version
    everywhere and `impl="onehot"` with the one-hot-matmul route (the JAX
    package's choice on an accelerator); the default samples with the CUDA
    kernel on the card.
    `nq`, `hd`, `ndl`, `d_ffn` and `num_denoising` (the CDN query budget;
    <= 0 turns CDN off) override the `TrackingModel` defaults, as the JAX
    model's fields do."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    spec = parse_model_yaml(cfg, nc=nc)
    kw = {k: v for k, v in (("nq", nq), ("hd", hd), ("ndl", ndl),
                            ("d_ffn", d_ffn),
                            ("num_denoising", num_denoising))
          if v is not None}
    model = TrackingModel(spec, tracker=tracker or TrackerConfig(), impl=impl,
                          **kw)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=dt).eval()
