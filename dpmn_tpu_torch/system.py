"""DPMN system: frozen PSN, the dual PGRM cascade, CMM and the α-blend (eval),
and the joint train step.

Counterpart of dpmn_tpu/system.py::DPMNSystem._sr_forward_impl (:583-594)
and ._train_step_impl (:502-507) with the device glyph atlas
(glyph_mode='atlas').  Per batch:
  1. the frozen CRNN reads the LR image; its softmaxed frames are the text
     prior of the frozen TATT PSN (system.py:264-279);
  2. branch 1: before each of the b1 graphic PGRMs a VisionLAN student reads
     the cascade image and the device glyph atlas renders its prior
     (system.py:314-345); residuals are cascade_list[:k];
  3. branch 2: b2 semantic PGRMs conditioned on to_mask of the cascade image,
     residuals cascade_list[:(k - b2)] (system.py:397-405);
  4. CMM fuses the two branch outputs; the result is blended with the PSN
     output by α (system.py:427-434, :593-594).
The losses and the distill cascade reach only the train step.  With
`sr_share` both branches run model_list[0], a reference quirk.

Serving modes of the eval forward (system.py:96, :281-313, :583-625):
  * `sr_forward(lr, glyph_from_psn=True)`: the reference test() quirk
    (super_resolution.py:648): every student reads the PSN output, so the b1
    students run as one vmapped call over their stacked parameters and the
    b1 priors come out of one glyph render of b1 * B rows;
  * `student_dtype="bfloat16"`: the students, and only they, run on a bf16
    copy of their parameters and a bf16 input; their argmax ids feed the
    prior as before;
  * `sr_forward_bf16(lr, glyph_from_psn=False)`: the forward on a bf16 copy
    of the parameters and BatchNorm statistics of the PSN, CRNN, students,
    PGRMs, distills and CMM, on bf16 input, the output returned float32.
    The glyph atlas tables stay float32; the prior is cast to the cascade's
    dtype, as the JAX package's glyphs.astype(dtype) does (system.py:345).
Each bf16 copy is made at its first use and made again when a float32
parameter or statistic it copies has changed since (a tensor's `_version`,
which `train_step`'s updates and `from_jax`'s copies move): the counterpart
of the JAX package's new-state rule.

`train_step` (system.py:452-500) runs the frozen PSN, CRNN and students
under no_grad in eval mode (their priors carry no gradient, :279, :345,
:401) and the PGRMs, distills and CMM in train mode; the loss is the sum of
image_loss(sr, hr[:3]) * 100 per PGRM and for the CMM output and the distill
losses * 100, over b1 + b2 + 1.  The update is the global pre-clip gradient
norm, then a clip at 0.25 per top-level module (pgrm_i, cmm, distill_i;
per_module_clip, :65-83), then Adam (or AdamW with weight decay 0.01) with
betas (beta1, 0.999) and eps 1e-8.  A parameter that autograd leaves without
a gradient (the unused weight_list_i) gets a zero one, as optax sees it.

`train_core` picks the PGRMs' training attention core: "block" (kernel K3,
the default), "attention" (K4) or "full" (K5); None reads the JAX package's
DPMN_TPU_FUSE_QKV / DPMN_TPU_FUSE_SKCONV (models/pgrm.py
`resolve_train_core`).  Eval always runs K1.

Entry points keep the JAX package's NHWC contract: (B, h, w, 4) LR in,
(B, 2h, 2w, 3) SR out; (B, 2h, 2w, 4) HR for training.  Modules run NCHW on
`device`: the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import copy
import weakref
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn as nn

from . import resolve_device
from .config import Args, TrainCfg, parse_pgrm_hparams
from .data.glyph_atlas import DeviceGlyph
from .losses import image_loss
from .models.cmm import CMM
from .models.crnn import CRNN, parse_crnn_input
from .models.distill import DistillModule
from .models.pgrm import PGRM
from .models.tatt import TSRN_TL_TRANS
from .models.visionlan import VisionLAN, parse_visionlan_input
from .ops.dropout import TrainRng
from .ops.mask_prior import to_mask


def _state_stamp(modules) -> tuple:
    """What identifies the values of the modules' parameters and buffers: each
    tensor's identity and version counter (in-place updates move it)."""
    return tuple((id(t), t._version) for m in modules for t in (*m.parameters(), *m.buffers()))


def bf16_copy(module: nn.Module) -> nn.Module:
    """A copy of `module` whose parameters (without grad) and persistent
    floating-point buffers (the BatchNorm statistics) are bf16; the derived
    non-persistent buffers (positional codes, shift masks, index tables)
    are shared, as they are."""
    memo = {}
    for mod in module.modules():
        for p in mod.parameters(recurse=False):
            memo[id(p)] = nn.Parameter(p.detach().to(torch.bfloat16), requires_grad=False)
        for name, buf in mod.named_buffers(recurse=False):
            derived = name in mod._non_persistent_buffers_set or not buf.is_floating_point()
            memo[id(buf)] = buf if derived else buf.to(torch.bfloat16)
    return copy.deepcopy(module, memo)


class Bf16Copy:
    """A bf16 copy (`bf16_copy`) of named modules, made at the first `get`
    and made again when a parameter or buffer of theirs has changed since;
    `get` returns the copies as attributes of a namespace (no nn.Module, so
    they are no submodules of the system); `made` counts the copies made."""

    def __init__(self, **modules):
        self.sources = modules
        self.stamp, self.nets, self.made = None, None, 0

    def get(self) -> SimpleNamespace:
        stamp = _state_stamp(self.sources.values())
        if stamp != self.stamp:
            self.nets = None  # free the old copy first
            self.nets = SimpleNamespace(**{k: bf16_copy(m) for k, m in self.sources.items()})
            self.stamp, self.made = stamp, self.made + 1
        return self.nets


class StackedStudents:
    """The students as one vmapped call over their stacked parameters and
    buffers (torch.func.stack_module_state), stacked again when one of them
    has changed: (B, 3, 64, 256) → logits (b1, B, 25, C), lengths (b1, B)."""

    def __init__(self, students: nn.ModuleList):
        self.students = students
        self.base = copy.deepcopy(students[0]).to("meta")
        self.stamp, self.state = None, None

    def __call__(self, x: torch.Tensor):
        stamp = _state_stamp(self.students)
        if stamp != self.stamp:
            self.state = None
            self.state = torch.func.stack_module_state(list(self.students))
            self.stamp = stamp

        def one(params, buffers):
            return torch.func.functional_call(self.base, (params, buffers), (x,))

        return torch.func.vmap(one)(*self.state)


class DPMNSystem(nn.Module):
    def __init__(self, cfg: TrainCfg, args: Args, device=None, seed: int = 0, train_core: str = None,
                 student_dtype: str = None):
        super().__init__()
        device = resolve_device(device)
        if student_dtype not in (None, "bfloat16"):
            raise ValueError(f"student_dtype {student_dtype!r}: None or 'bfloat16'")
        self.student_dtype = student_dtype
        a = self.args = args
        self.cfg = cfg
        if a.arch != "tatt":
            raise NotImplementedError(f"arch {a.arch!r}: this port carries the TATT PSN only")
        if not a.mask:
            raise NotImplementedError("the TATT PSN of this port takes 4-channel (masked) LR input")
        if a.font_path is not None:
            raise NotImplementedError("the glyph atlas is committed for the default font only")
        hp = parse_pgrm_hparams(a)
        self.b1, self.b2 = a.stu_iter_b1, a.stu_iter_b2
        self.hr_shape = (cfg.height, cfg.width)

        def make_pgrm(iter_: int, graphic: bool) -> PGRM:
            def pick(lst, idx=iter_):
                return lst[min(idx, len(lst) - 1)]

            i = min(iter_, len(hp.depths) - 1) if len(hp.depths) == 1 else iter_
            depths_clamped = [pick(hp.depths, j) for j in range(iter_ + 1)]
            return PGRM(
                img_size=self.hr_shape, patch_size=pick(hp.patch_size, i), embed_dim=pick(hp.embed_dim, i),
                num_layers=pick(hp.depths, i), num_heads=tuple(pick(hp.num_heads, i)),
                window_size=tuple(pick(hp.window_size, i)), mlp_ratio=float(pick(hp.mlp_ratio, i)),
                drop_rate=float(pick(hp.drop_rate, i)), attn_drop_rate=float(pick(hp.attn_drop_rate, i)),
                drop_path_rate=float(pick(hp.drop_path_rate, i)), iter=iter_, graphic_mode=graphic,
                hidden_size=3, depths_total=sum(hp.depths), depths_before=sum(depths_clamped[:-1]),
                faithful=a.faithful, train_core=train_core,
            )

        if a.sr_share:
            pgrms = [make_pgrm(0, True), make_pgrm(self.b1, False)]
        else:
            pgrms = [make_pgrm(k, True) for k in range(self.b1)]
            pgrms += [make_pgrm(k, False) for k in range(self.b1, self.b1 + self.b2)]
        self.pgrms = nn.ModuleList(pgrms)
        self.cmm = CMM()
        self.psn = TSRN_TL_TRANS(scale_factor=cfg.down_sample_scale, width=cfg.width, height=cfg.height,
                                 srb_nums=a.srb, mask=a.mask, hidden_units=a.hd_u,
                                 out_text_channels=2 * a.hd_u, faithful=a.faithful)
        self.crnn_psn = CRNN()
        self.students = nn.ModuleList([VisionLAN() for _ in range(self.b1)])
        self.glyph = DeviceGlyph(self.hr_shape)
        self.distills = nn.ModuleList([DistillModule() for _ in range(max(self.b1 + self.b2 - 2, 0))])
        init_weights(self, seed)
        self.device = device
        self.to(device).eval()
        if cfg.optimizer not in ("Adam", "AdamW"):
            raise ValueError(f"optimizer {cfg.optimizer!r}")
        self.optimizer = None  # made at the first update: eval never needs it
        # the serving modes' bf16 copies and the stacked students, made at first use
        self.student_bf16 = Bf16Copy(students=self.students)
        self.state_bf16 = Bf16Copy(psn=self.psn, crnn_psn=self.crnn_psn, students=self.students, pgrms=self.pgrms,
                                   cmm=self.cmm, distills=self.distills)
        self._stacks = weakref.WeakKeyDictionary()  # students ModuleList -> StackedStudents

    def trainable_modules(self) -> dict:
        """The top-level trainable modules by their dpmn_tpu names; each is
        clipped on its own (per_module_clip)."""
        return {**{f"pgrm_{i}": m for i, m in enumerate(self.pgrms)}, "cmm": self.cmm,
                **{f"distill_{i}": m for i, m in enumerate(self.distills)}}

    def trainable_parameters(self) -> list:
        return [p for m in self.trainable_modules().values() for p in m.parameters()]

    # ------------------------------------------------------------- internals

    def _psn_forward(self, images_lr, nets=None):
        """Frozen CRNN text prior → TATT PSN (super_resolution.py:156-169)."""
        nets = nets or self
        logits = nets.crnn_psn(parse_crnn_input(images_lr[:, :3]))  # (T, B, 37)
        emb = torch.softmax(logits, dim=-1).permute(1, 2, 0)[:, :, None, :]  # (B, 37, 1, T)
        return nets.psn(images_lr, emb)[0]

    def _students(self, nets):
        """The students a forward runs: their bf16 copy under student_dtype
        (system.py:281-287; a bf16 state's students are bf16 already)."""
        if nets is self and self.student_dtype is not None:
            return self.student_bf16.get().students
        return nets.students

    def _student_input(self, students, images):
        return parse_visionlan_input(images[:, :3]).to(students[0].w_vrm.weight.dtype)

    def _glyph_prior(self, k: int, cascade, nets=None):
        """Student k reads the cascade image; the atlas renders its word,
        cast to the cascade's dtype."""
        students = self._students(nets or self)
        logits, lengths = students[k](self._student_input(students, cascade))
        return self._prior_from_preds(logits.argmax(-1), lengths).to(cascade.dtype)

    def _glyph_priors_shared(self, images, nets=None):
        """All b1 glyph priors from one image, the test() quirk
        (system.py:289-313): the students run as one vmapped call over their
        stacked parameters, and the b1 * B words go through one render.
        Returns a list of b1 (B, 2, H, W) priors."""
        students = self._students(nets or self)
        if students not in self._stacks:
            self._stacks[students] = StackedStudents(students)
        logits, lengths = self._stacks[students](self._student_input(students, images))
        b = images.shape[0]
        priors = self._prior_from_preds(logits.argmax(-1).reshape(self.b1 * b, -1), lengths.reshape(-1))
        return list(priors.to(images.dtype).split(b))

    def _prior_from_preds(self, preds, lengths):
        pos = torch.arange(preds.shape[1], device=preds.device)[None, :]
        ids = torch.where(pos < lengths[:, None], preds, 0)
        # drop EOS / blank ids and compact left (a stable sort of ids == 0)
        order = torch.argsort((ids == 0).to(torch.int8), dim=1, stable=True)
        ids = torch.gather(ids, 1, order)
        return self.glyph(ids, (ids > 0).sum(dim=1))

    def _cascade(self, images_lr_psn, images_hr=None, rng: TrainRng = None, nets=None, glyph_from_psn=False):
        """The two branches and CMM → (sr, loss).  With `images_hr` (the
        train step) the loss sums the per-PGRM and CMM image losses and the
        distill cascade (system.py:383-436); without, it is None.  `nets`
        holds the modules to run (the system itself by default);
        `glyph_from_psn` gives every student the PSN output (system.py:386-391)."""
        nets = nets or self
        pgrm = lambda idx: nets.pgrms[0 if self.args.sr_share else idx]
        losses = []

        def image_term(sr):
            if images_hr is not None:
                losses.append(image_loss(sr, images_hr[:, :3], self.args.gradient) * 100.0)

        cascade, b1_list = images_lr_psn, []
        if glyph_from_psn:
            with torch.no_grad():
                shared = self._glyph_priors_shared(images_lr_psn, nets)
        for k in range(self.b1):
            with torch.no_grad():
                prior = shared[k] if glyph_from_psn else self._glyph_prior(k, cascade, nets)
            sr = pgrm(k)(prior, cascade[:, :3], b1_list[:k], rng)
            b1_list.append(sr)
            cascade = sr
            image_term(sr)
        cascade, b2_list = images_lr_psn, []
        for k in range(self.b1, self.b1 + self.b2):
            with torch.no_grad():
                prior = to_mask(cascade).to(cascade.dtype)
            sr = pgrm(k)(prior, cascade[:, :3], b2_list[: (k - self.b2)], rng)
            b2_list.append(sr)
            cascade = sr
            image_term(sr)
        if images_hr is not None:  # distill, deep → shallow per branch (:418-425)
            feat = b1_list[-1]
            for k in range(self.b1 - 1, 0, -1):
                loss, feat = self.distills[k - 1](feat, b1_list[k - 1])
                losses.append(loss * 100.0)
            feat = b2_list[-1]
            for k in range(self.b2 - 1, 0, -1):
                loss, feat = self.distills[k + self.b1 - 2](feat, b2_list[k - 1])
                losses.append(loss * 100.0)
        sr = nets.cmm(b1_list[-1], b2_list[-1])
        image_term(sr)
        if images_hr is None:
            return sr, None
        return sr, sum(losses[1:], losses[0]) / (self.b1 + self.b2 + 1)

    def _nchw(self, images, nets=None) -> torch.Tensor:
        """NHWC images → NCHW on the device, in the dtype of the PSN's
        parameters in `nets` (float32 unless the caller converted the
        system, bf16 for the bf16 copy)."""
        x = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
        return x.to(self.device, (nets or self).psn.conv_in.weight.dtype).permute(0, 3, 1, 2).contiguous()

    def _forward(self, images_lr, nets, glyph_from_psn: bool) -> torch.Tensor:
        """The eval forward (system.py:583-594) on `nets`, NHWC in and out."""
        images_lr_psn = self._psn_forward(self._nchw(images_lr, nets), nets)
        sr, _ = self._cascade(images_lr_psn, nets=nets, glyph_from_psn=glyph_from_psn)
        alpha = self.args.alpha
        out = alpha * sr + (1 - alpha) * images_lr_psn[:, :3]
        return out.permute(0, 2, 3, 1).contiguous()

    # ------------------------------------------------------------ entry points

    @torch.no_grad()
    def sr_forward(self, images_lr, glyph_from_psn: bool = False) -> torch.Tensor:
        """(B, h, w, 4) NHWC LR images (numpy or tensor) → (B, 2h, 2w, 3) NHWC SR.
        `glyph_from_psn`: every student reads the PSN output (the test() path)."""
        return self._forward(images_lr, self, glyph_from_psn)

    @torch.no_grad()
    def sr_forward_bf16(self, images_lr, glyph_from_psn: bool = False) -> torch.Tensor:
        """The bf16 serving forward (system.py:597-625): sr_forward on the bf16
        copy of the state and bf16 input; the SR comes back float32."""
        return self._forward(images_lr, self.state_bf16.get(), glyph_from_psn).float()

    def train_step(self, images_hr, images_lr, seed: int = 0) -> dict:
        """One joint train step on (B, 2h, 2w, 4) HR and (B, h, w, 4) LR NHWC
        images (numpy or tensors); `seed` seeds the step's dropout.  Updates
        the trainable parameters, the BatchNorm statistics and the optimizer
        state in place; returns {"loss", "grad_norm"} as 0-d tensors on the
        device, without a host sync."""
        loss, grads = self._micro_grads(images_hr, images_lr, seed)
        return self._apply_update(grads, loss)

    def _micro_grads(self, images_hr, images_lr, seed: int):
        """The loss and the gradient of every trainable parameter (in
        `trainable_parameters()` order, zeros where autograd gives none);
        moves the BatchNorm running statistics (system.py:452-479)."""
        loss = self._train_loss(images_hr, images_lr, seed)
        return loss.detach(), self._loss_grads(loss)

    def _train_loss(self, images_hr, images_lr, seed: int) -> torch.Tensor:
        """The forward of the train step: the frozen PSN under no_grad, the
        cascade with the trainable modules in train mode, the joint loss."""
        hr, lr = self._nchw(images_hr), self._nchw(images_lr)
        with torch.no_grad():
            images_lr_psn = self._psn_forward(lr)
        modules = self.trainable_modules().values()
        for m in modules:
            m.train()
        try:
            return self._cascade(images_lr_psn, hr, TrainRng(seed, self.device))[1]
        finally:
            for m in modules:
                m.eval()

    def _loss_grads(self, loss: torch.Tensor) -> list:
        params = self.trainable_parameters()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    def _apply_update(self, grads, loss) -> dict:
        """Global pre-clip norm, the per-module clip at 0.25, the optimizer
        step (system.py:481-500)."""
        sq = [n * n for n in torch._foreach_norm(grads)]
        grad_norm = torch.sqrt(torch.stack(sq).sum())
        i = 0
        for module in self.trainable_modules().values():
            ps = list(module.parameters())
            norm = torch.sqrt(torch.stack(sq[i:i + len(ps)]).sum())
            scale = torch.clamp(0.25 / (norm + 1e-6), max=1.0)
            for p, g in zip(ps, grads[i:i + len(ps)]):
                p.grad = g * scale
            i += len(ps)
        if self.optimizer is None:
            adam = dict(lr=self.cfg.lr, betas=(self.cfg.beta1, 0.999), eps=1e-8)
            params = self.trainable_parameters()
            self.optimizer = (torch.optim.AdamW(params, weight_decay=0.01, **adam) if self.cfg.optimizer == "AdamW"
                              else torch.optim.Adam(params, **adam))
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return {"loss": loss, "grad_norm": grad_norm}


def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded random weights from a CPU torch.Generator, so the same seed gives
    the same weights on any device: Linear / Conv / ConvTranspose / RNN / MHA
    projection weights and biases uniform in ±1/sqrt(fan_in) (RNNs: hidden
    size); norms at identity; PReLU slopes 0.25; the relative-position tables
    normal(0, 0.02); embeddings (MORAN's bare char_embeddings too) and the
    InfoTransformer's init_factor normal(0, 1); the PGRM residual weights at
    1; an STN head's stn_fc2 as the reference initializes it (weight 0, bias
    the margin-0.01 control points), so its TPS warp starts near the
    identity.  Raises on a parameter no rule covers, so none is left
    uninitialized."""
    from .models.stn import init_ctrl_points
    from .models.tatt import InfoTransformer
    from .ops.attention import MultiHeadAttention
    from .ops.gru import BiGRU

    gen = torch.Generator().manual_seed(seed)

    def uniform(p, fan_in):
        bound = 1.0 / max(fan_in, 1) ** 0.5
        return torch.rand(p.shape, generator=gen) * 2 * bound - bound

    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if mname.endswith("stn_fc2"):
                value = (torch.zeros(p.shape) if pname == "weight"
                         else torch.from_numpy(init_ctrl_points(p.shape[0] // 2).reshape(-1)))
            elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                value = uniform(p, mod.weight[0].numel())
            elif isinstance(mod, nn.ConvTranspose2d):
                value = uniform(p, mod.weight.shape[0] * mod.weight[0, 0].numel())
            elif isinstance(mod, (nn.LSTM, nn.GRU, BiGRU)):
                value = uniform(p, mod.weight_hh_l0.shape[1])
            elif isinstance(mod, nn.GRUCell):
                value = uniform(p, mod.hidden_size)
            elif isinstance(mod, MultiHeadAttention):
                value = uniform(p, mod.embed_dim) if pname == "in_proj_weight" else torch.zeros(p.shape)
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)):
                value = torch.ones(p.shape) if pname == "weight" else torch.zeros(p.shape)
            elif isinstance(mod, nn.PReLU):
                value = torch.full(p.shape, 0.25)
            elif (isinstance(mod, nn.Embedding) or pname == "char_embeddings"
                  or (isinstance(mod, InfoTransformer) and pname == "init_factor")):
                value = torch.randn(p.shape, generator=gen)
            elif pname.startswith("relative_position_bias_table"):
                value = torch.randn(p.shape, generator=gen) * 0.02
            elif mname.endswith("weight_list"):
                value = torch.ones(p.shape)
            else:
                raise TypeError(f"init_weights: no rule for {mname}.{pname}")
            with torch.no_grad():
                p.copy_(value)
