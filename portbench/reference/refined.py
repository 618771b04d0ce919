"""The reference's stage-II pose step with the DeepIM refiner in the loop:
a frozen copy of the port's refined pose step (engine/self_engine.py::
forward_losses with a refine function, refiner_batch;
make_self_train_step with a refiner), composed from steps.py: the step of
steps.make_self_train_step with the teacher's pseudo pose refined by
steps.refine before the labels read it.

It runs in float32 with TF32 off (steps.plain_float32), as steps.py does.
What differs from the port's arithmetic, none of which changes the
function computed:
- the refiner renders through the plain fine stage (the port: kernel B1),
  hard, as steps.refine renders;
- the refine runs in blocks of `refine_block` ROIs (each ROI's refine is
  its own: its render, its zoom, its crop and its network input; the
  refiner runs in eval mode, so no statistic joins the ROIs);
- the refiner's batch leaves out the pseudo mask the port passes as the
  observed mask (obs_mask): a 6-channel refiner does not read it, and
  this reference takes only 6-channel refiners;
- the rest is steps.make_self_train_step's: LAB by autograd of lab_loss,
  the student render in blocks of `block` ROIs, the student backbone
  checkpointed stage by stage (checkpoint_backbone).
The control (low=torch.bfloat16 under steps.fp8_matmuls) runs GDR-Net
under autocast and takes a refiner built in bfloat16
(steps.build_deepim(..., torch.bfloat16)), as the port runs both.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .config import Config
from .engine.train_state import TrainState, gated_ema_decay
from .losses.mask_losses import get_mask_prob
from .losses.self_loss import compute_self_loss_pose
from .models.deepim import DeepIM
from .steps import (_checkpointed_backbone, _descend, _forward, refine,
                    render_student_pose)


def refiner_batch(batch: dict[str, Tensor]) -> dict[str, Tensor]:
    """The refiner's batch in the ROI frame: roi_img observed with the ROI
    intrinsics (roi_zoom_K), each ROI's class mesh."""
    cls = batch["roi_cls"].long()
    return {"obs_img": batch["roi_img"], "K": batch["roi_zoom_K"],
            "verts": batch["mesh_verts"][cls],
            "faces": batch["mesh_faces"][cls],
            "colors": batch["mesh_colors"][cls], "roi_cls": batch["roi_cls"]}


def refine_blocks(rcfg: Config, refiner: DeepIM, rb: dict[str, Tensor],
                  rot: Tensor, trans: Tensor, block: int
                  ) -> tuple[Tensor, Tensor]:
    """steps.refine of the poses (rot, trans) in blocks of `block` ROIs."""
    rots, transs = [], []
    for i in range(0, rot.shape[0], block):
        sl = slice(i, i + block)
        part = {k: v[sl] for k, v in rb.items()}
        part["init_rot"], part["init_trans"] = rot[sl], trans[sl]
        r, t = refine(rcfg, refiner, part)
        rots.append(r.float())
        transs.append(t.float())
    return torch.cat(rots), torch.cat(transs)


def make_refined_train_step(cfg: Config, lpips, refiner: DeepIM,
                            rcfg: Config, block: int = 16,
                            refine_block: int = 16,
                            checkpoint_backbone: bool = True, low=None):
    """step(state, batch, pseudo_out=None) -> metrics: one stage-II pose
    step whose pseudo pose, the teacher's, is refined by `refiner` (in
    eval mode, its Config rcfg: rcfg.deepim.n_iter_test iterations) before
    the labels; pseudo_out, if given, receives the refined pose as "rot"
    and "trans". cfg must be float32 with self_sup.lab_impl 'direct' and
    self_sup.refine_with_deepim."""
    ss = cfg.self_sup
    if cfg.dist.compute_dtype != "float32" or ss.lab_impl != "direct":
        raise ValueError("the reference step runs float32 with direct LAB")
    if not ss.refine_with_deepim:
        raise ValueError("the refined step needs self_sup.refine_with_deepim")
    if rcfg.deepim.in_channels != 6:
        raise ValueError("the reference refines with 6-channel inputs only")
    decay_fn = gated_ema_decay(ss.ema_decay, cfg.solver.ema_warmup_iters, 1)
    s, o = cfg.model.input_res, cfg.model.output_res
    refiner = refiner.eval()

    def step(state: TrainState, batch: dict[str, Tensor], pseudo_out=None):
        net = state.model.eval()
        bb = net.backbone
        if checkpoint_backbone:
            bb.forward = _checkpointed_backbone(bb)
        try:
            out = _forward(net, batch, low)
        finally:
            bb.__dict__.pop("forward", None)
        with torch.no_grad():
            tout = _forward(state.teacher, batch, low)
        prob = get_mask_prob(tout["mask_logits"],
                             cfg.model.loss.mask_loss_type)[..., 0]
        vis_lr = (prob > 0.5).float()
        vis = vis_lr.repeat_interleave(s // o, 1).repeat_interleave(s // o, 2)
        rot, trans = refine_blocks(rcfg, refiner, refiner_batch(batch),
                                   tout["rot"].detach(),
                                   tout["trans"].detach(), refine_block)
        if pseudo_out is not None:
            pseudo_out.update(rot=rot, trans=trans)
        pseudo = {"vis_mask": vis, "vis_mask_lr": vis_lr,
                  "coor": tout["coor"],
                  "region": torch.softmax(tout["region_logits"], dim=-1),
                  "rot": rot, "trans": trans}
        ren = render_student_pose(cfg, batch, out["rot"], out["trans"], block)
        ld = compute_self_loss_pose(ss, ren, out, pseudo, batch,
                                    lpips_fn=lpips, impl="plain")
        return _descend(state, ld, decay_fn)

    return step
