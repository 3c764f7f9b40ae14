"""Minimum viable EPro-PnP in PyTorch: fit a correspondence MLP to the
identity pose map.

Counterpart of ``demo/fit_identity.py`` (the reference's
``demo/fit_identity.ipynb``): a small MLP maps an input pose to a 2D-3D
correspondence set ``(x3d, x2d, w2d)``; training with the Monte Carlo pose
loss (plus derivative regularisation on ``pose_opt_plus``) teaches the
correspondences to encode the pose, so that solving PnP on them recovers
it. The same model (MLP 7 -> 1024 -> num_points * 7, log-softmax weights
with a learned global ``log_weight_scale``), the same
``EProPnP6DoF(mc 512/4, LMSolver(6, 10, RSLMSolver(8, 128, 5)))`` stack,
the same Adam parameter groups (mlp lr 1e-4, log_weight_scale lr 1e-2) and
losses ``loss_mc + 0.1 * smooth_l1(t) + 0.1 * (1 - (q.q_gt)^2) * 2``.

With ``use_pallas`` (the default) the solves run through K1: the init's
proposals in the trust region, the main solve in the trust region with its
JtJ (the pose covariance of the AMIS proposal). Runs on the CUDA card
unless ``--device cpu``.

Run: ``python -m epropnp_tpu_torch.demo.fit_identity``
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch
from torch import nn

from ..models.losses.monte_carlo_pose_loss import (
    MonteCarloPoseLossState,
    monte_carlo_pose_loss,
)
from ..ops.pnp import (
    AdaptiveHuberPnPCost,
    EProPnP6DoF,
    LMSolver,
    PerspectiveCamera,
    RSLMSolver,
)


def make_epropnp(mc_samples=512, num_iter=4, lm_iter=10, rs_points=8,
                 rs_proposals=128, rs_iter=5, use_pallas=True):
    return EProPnP6DoF(
        mc_samples=mc_samples, num_iter=num_iter,
        solver=LMSolver(
            dof=6, num_iter=lm_iter, use_pallas=use_pallas,
            init_solver=RSLMSolver(
                dof=6, num_points=rs_points, num_proposals=rs_proposals,
                num_iter=rs_iter, use_pallas=use_pallas)))


class CorrespondenceNet(nn.Module):
    """MLP 7 -> hidden -> num_points * 7 with LeakyReLU, and the learned
    global ``log_weight_scale`` (torch's default Linear initialisation, as
    the reference and the JAX demo)."""

    def __init__(self, num_points=64, hidden=1024):
        super().__init__()
        self.num_points = num_points
        self.mlp = nn.Sequential(nn.Linear(7, hidden), nn.LeakyReLU(0.01),
                                 nn.Linear(hidden, num_points * 7))
        self.log_weight_scale = nn.Parameter(torch.zeros(2))

    def forward(self, in_pose):
        out = self.mlp(in_pose).reshape(-1, self.num_points, 7)
        x3d, x2d, w2d = out.split([3, 2, 2], -1)
        w2d = torch.exp(torch.log_softmax(w2d, -2) + self.log_weight_scale)
        return x3d, x2d, w2d


def make_optimizer(net, lr_mlp=1e-4, lr_scale=1e-2):
    """Adam with the reference notebook's two parameter groups."""
    return torch.optim.Adam([
        dict(params=net.mlp.parameters(), lr=lr_mlp),
        dict(params=[net.log_weight_scale], lr=lr_scale)])


def _camera(n, like):
    return PerspectiveCamera(cam_mats=torch.eye(
        3, dtype=like.dtype, device=like.device).expand(n, 3, 3))


def loss_fn(net, epropnp, batch_in, batch_out, mc_state, gen):
    x3d, x2d, w2d = net(batch_in)
    cost_fun = AdaptiveHuberPnPCost(relative_delta=0.5).set_param(
        x2d.detach(), w2d)
    (_, _, pose_opt_plus, _, pose_sample_logweights,
     cost_tgt) = epropnp.monte_carlo_forward(
        x3d, x2d, w2d, _camera(x3d.shape[0], x3d), cost_fun, rng=gen,
        pose_init=batch_out, force_init_solve=True,
        with_pose_opt_plus=True)
    norm_factor = torch.exp(net.log_weight_scale.detach()).mean()
    loss_mc, new_mc_state = monte_carlo_pose_loss(
        pose_sample_logweights, cost_tgt, norm_factor, mc_state,
        momentum=0.1, training=True)
    dist_t = torch.linalg.vector_norm(pose_opt_plus[:, :3] - batch_out[:, :3],
                                      dim=-1)
    beta = 1.0
    loss_t = torch.where(dist_t < beta, 0.5 * dist_t.square() / beta,
                         dist_t - 0.5 * beta).mean()
    dot_quat = (pose_opt_plus[:, 3:] * batch_out[:, 3:]).sum(-1)
    loss_r = ((1.0 - dot_quat.square()) * 2.0).mean()
    loss = loss_mc + 0.1 * loss_t + 0.1 * loss_r
    return loss, dict(loss=loss, loss_mc=loss_mc, loss_t=loss_t,
                      loss_r=loss_r, norm_factor=norm_factor), new_mc_state


def train_step(net, opt, epropnp, mc_state, batch_in, batch_out, gen):
    """One step with the NaN guard: a non-finite loss or gradient skips the
    update and keeps the EMA. Returns ``(mc_state, metrics, skipped)``."""
    opt.zero_grad(set_to_none=True)
    loss, metrics, new_mc_state = loss_fn(net, epropnp, batch_in, batch_out,
                                          mc_state, gen)
    loss.backward()
    finite = torch.stack([torch.isfinite(p.grad).all()
                          for p in net.parameters() if p.grad is not None]
                         + [torch.isfinite(loss)]).all()
    if not bool(finite):
        return mc_state, metrics, True
    opt.step()
    return new_mc_state, metrics, False


def _normalize_quat(pose):
    q = pose[:, 3:]
    return torch.cat([pose[:, :3], q / torch.clamp(
        torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)], -1)


def gen_poses(gen, n, noise=0.01, device=None):
    """Input poses (z shifted by 5) and noisy targets, from ``gen``."""
    draw = lambda: torch.randn((n, 7), generator=gen,  # noqa: E731
                               device=gen.device)
    in_pose = draw()
    in_pose[:, 2] += 5.0
    in_pose = _normalize_quat(in_pose)
    out_pose = _normalize_quat(in_pose + draw() * noise)
    return in_pose.to(device), out_pose.to(device)


@torch.no_grad()
def evaluate(net, epropnp, test_pose):
    x3d, x2d, w2d = net(test_pose)
    cost_fun = AdaptiveHuberPnPCost(relative_delta=0.5).set_param(x2d, w2d)
    gen = torch.Generator(device=test_pose.device).manual_seed(0)
    pose_opt = epropnp(x3d, x2d, w2d, _camera(x3d.shape[0], x3d), cost_fun,
                       rng=gen)[0]
    dist_t = torch.linalg.vector_norm(pose_opt[:, :3] - test_pose[:, :3],
                                      dim=-1)
    dot_quat = (pose_opt[:, 3:] * test_pose[:, 3:]).sum(-1)
    dist_theta = 2.0 * torch.acos(torch.clamp(dot_quat.abs(), 0.0, 1.0))
    return dist_t.mean().item(), dist_theta.mean().item()


def run(n_data=65536, batch_size=256, n_epoch=10, noise=0.01, num_points=64,
        hidden=1024, seed=0, epropnp=None, log_every=32, verbose=True,
        use_pallas=True, device: Optional[str] = None):
    """Train the identity-fit model; returns the final metrics: mean
    translation and orientation errors on 1024 test poses, the per-step
    losses, the skipped steps and the training time (s)."""
    device = torch.device('cuda' if device is None else device)
    epropnp = epropnp or make_epropnp(use_pallas=use_pallas)
    gen = torch.Generator(device=device).manual_seed(seed)
    in_pose, out_pose = gen_poses(gen, n_data, noise, device)
    torch.manual_seed(seed)
    net = CorrespondenceNet(num_points, hidden).to(device)
    opt = make_optimizer(net)
    mc_state = MonteCarloPoseLossState.create(device=device)

    losses, skipped, step = [], 0, 0
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for epoch in range(n_epoch):
        perm = torch.randperm(n_data, generator=gen, device=gen.device).to(
            device)
        for i in range(n_data // batch_size):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            mc_state, metrics, skip = train_step(
                net, opt, epropnp, mc_state, in_pose[idx], out_pose[idx],
                gen)
            skipped += skip
            step += 1
            losses.append(float('nan') if skip else metrics['loss'].item())
            if verbose and step % log_every == 1:
                m = {k: v.item() for k, v in metrics.items()}
                print(f'epoch {epoch + 1} step {step}: loss={m["loss"]:.4f} '
                      f'mc={m["loss_mc"]:.4f} t={m["loss_t"]:.4f} '
                      f'r={m["loss_r"]:.4f} nf={m["norm_factor"]:.4f} '
                      f'({time.perf_counter() - t0:.1f}s)')
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0

    test_pose, _ = gen_poses(gen, min(1024, n_data), noise, device)
    trans_err, orient_err = evaluate(net, epropnp, test_pose)
    results = dict(mean_trans_err=trans_err, mean_orient_err=orient_err,
                   losses=losses, skipped=skipped, steps=step,
                   train_s=train_s)
    if verbose:
        print(f'Mean Translation Error: {trans_err:.6f}')
        print(f'Mean Orientation Error: {orient_err:.6f}')
        print(f'{step} steps in {train_s:.1f} s, {skipped} skipped')
    return results


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--n-data', type=int, default=65536)
    p.add_argument('--batch-size', type=int, default=256)
    p.add_argument('--epochs', type=int, default=10)
    p.add_argument('--noise', type=float, default=0.01)
    p.add_argument('--device', default=None,
                   help='torch device (default: the CUDA card)')
    p.add_argument('--no-kernels', action='store_true',
                   help='solve with the plain torch solver instead of K1')
    args = p.parse_args()
    run(n_data=args.n_data, batch_size=args.batch_size, n_epoch=args.epochs,
        noise=args.noise, device=args.device,
        use_pallas=not args.no_kernels)


if __name__ == '__main__':
    main()
