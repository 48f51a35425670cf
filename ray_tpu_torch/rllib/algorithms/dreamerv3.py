"""DreamerV3 (model-based RL: learn a world model, act in imagination), the
port's counterpart of `ray_tpu/rllib/algorithms/dreamerv3.py`.

The same method at the same dims (the JAX package's "nano" row: deter 128,
8 x 8 categorical latents, embed 64, hidden 128): an RSSM world model (an
encoder, a GRU over [z, a] with fused gate weights, the posterior and prior
heads, the decoder, the symlog reward head and the continue head), its
KL-balanced dyn / rep losses with free bits, straight-through categorical
latents with a 1% uniform mix, and an actor and a critic trained in
imagination: the prior rolled H steps with the actor, lambda-returns on the
predicted rewards and continues, REINFORCE with return normalisation and an
entropy bonus. Three optax-default Adams (no weight decay, no clip), one
each for the world model, the actor and the critic.

On the card the algorithm's step is one CUDA graph
(`DreamerV3Learner.train_step_graphed`): the eager step launches some
thousands of small kernels, and its time is the host's launching them.

The networks are `nn.Module`s named like the JAX pytree's keys (`wm.enc.0`,
`wm.gru_x`, `actor.1`, ...), so `rllib/convert.py` carries the JAX
parameters and Adam states across. JAX's `lax.scan`s over time (the
posterior filter, the imagination rollout, the reversed lambda-returns)
are loops over time here, and the step is eager: JAX jits it whole.
Every `jax.random.categorical` draw is Gumbel-max, argmax(logits + g),
with the Gumbel noise g drawn from a `torch.Generator`: `train_step` and
`policy_step` take the noise as an optional argument, so that a test can
hand them JAX's own draws. The env comes from the port's registry
(`rllib/envs.py`), where JAX calls `gym.make`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.envs import make_env
from ray_tpu_torch.rllib.rl_module import _linear
from ray_tpu_torch.train.optim import AdamW, _adamw_, tree_leaves


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=DreamerV3)
        self.lr = 3e-4
        self.actor_lr = 1e-4
        self.critic_lr = 1e-4
        # model dims (a "nano" row of the reference's size table)
        self.deter_dim = 128          # GRU/deterministic state
        self.stoch_groups = 8
        self.stoch_classes = 8
        self.embed_dim = 64
        self.hidden_dim = 128
        self.batch_size_B = 8         # sequences per world-model batch
        self.batch_length_T = 16
        self.horizon_H = 10           # imagination rollout length
        self.gamma = 0.99
        self.gae_lambda = 0.95
        self.entropy_coeff = 3e-3
        self.free_bits = 1.0
        self.kl_dyn_scale = 0.5
        self.kl_rep_scale = 0.1
        self.train_ratio = 32         # model updates per iteration
        self.num_steps_per_iteration = 400
        self.buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 400

    def training(self, **kwargs) -> "DreamerV3Config":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self


class _SeqBuffer:
    """Episode-segment replay: stores transitions contiguously per episode
    and samples [B, T] windows (reference: dreamerv3's EpisodeReplayBuffer).

    Dreamer ARRIVAL convention: entry t is (obs_t, a_t, r_t, c_t) where
    a_t is the action chosen AT obs_t, while r_t / c_t describe ARRIVING
    at obs_t (reward emitted by the previous transition; c_t == 0 iff
    obs_t is terminal). The terminal observation IS stored (with a dummy
    action) — without it the continue head never sees a zero label and
    imagination can never predict episode end."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.episodes: List[Dict[str, list]] = []
        self._cur: Optional[Dict[str, list]] = None
        self.size = 0

    def start_episode(self):
        self._cur = {"obs": [], "actions": [], "rewards": [], "cont": []}

    def add(self, obs, action, reward, cont):
        self._cur["obs"].append(np.asarray(obs, np.float32))
        self._cur["actions"].append(int(action))
        self._cur["rewards"].append(float(reward))
        self._cur["cont"].append(float(cont))
        self.size += 1

    def end_episode(self):
        if self._cur and len(self._cur["obs"]) >= 2:
            self.episodes.append({
                k: np.asarray(v) for k, v in self._cur.items()})
        self._cur = None
        while self.size > self.capacity and self.episodes:
            self.size -= len(self.episodes.pop(0)["obs"])

    def sample(self, rng, B: int, T: int) -> Optional[Dict[str, np.ndarray]]:
        pool = [ep for ep in self.episodes if len(ep["obs"]) >= T]
        if not pool:
            return None
        out = {k: [] for k in ("obs", "actions", "rewards", "cont")}
        for _ in range(B):
            ep = pool[int(rng.integers(len(pool)))]
            start = int(rng.integers(len(ep["obs"]) - T + 1))
            for k in out:
                out[k].append(ep[k][start:start + T])
        return {k: np.stack(v) for k, v in out.items()}


def _mlp_layers(sizes, gen: torch.Generator) -> nn.ModuleList:
    return nn.ModuleList(_linear(a, b, gen) for a, b in zip(sizes, sizes[1:]))


def _mlp(layers: nn.ModuleList, x):
    """silu between the dense layers, none after the last (JAX's `mlp`)."""
    for layer in layers[:-1]:
        x = F.silu(layer(x))
    return layers[-1](x)


class WorldModel(nn.Module):
    """The RSSM's networks, named as the JAX `wm` pytree's keys."""

    def __init__(self, obs_dim: int, num_actions: int, D: int, Z: int,
                 E: int, H: int, gen: torch.Generator):
        super().__init__()
        self.enc = _mlp_layers([obs_dim, E, E], gen)
        # GRU over [z, a] with state h: fused gate weights
        self.gru_x = _linear(Z + num_actions, 3 * D, gen)
        self.gru_h = _linear(D, 3 * D, gen)
        self.post = _mlp_layers([D + E, H, Z], gen)
        self.prior = _mlp_layers([D, H, Z], gen)
        self.dec = _mlp_layers([D + Z, H, obs_dim], gen)
        self.rew = _mlp_layers([D + Z, H, 1], gen)
        self.cont = _mlp_layers([D + Z, H, 1], gen)

    def gru(self, h, x):
        r, u, c = torch.chunk(self.gru_x(x) + self.gru_h(h), 3, dim=-1)
        r, u = torch.sigmoid(r), torch.sigmoid(u)
        return u * h + (1 - u) * torch.tanh(r * c)


class DreamerModel(nn.Module):
    """The world model, the actor and the critic: the JAX `params` pytree
    {"wm", "actor", "critic"} as submodules, drawn on the CPU from
    `generator` and moved to `device`."""

    def __init__(self, obs_dim: int, num_actions: int, *, deter_dim=128,
                 stoch_groups=8, stoch_classes=8, embed_dim=64,
                 hidden_dim=128, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator()
        self.obs_dim, self.num_actions = obs_dim, num_actions
        self.G, self.C = stoch_groups, stoch_classes
        self.D, self.Z = deter_dim, stoch_groups * stoch_classes
        D, Z, H = self.D, self.Z, hidden_dim
        self.wm = WorldModel(obs_dim, num_actions, D, Z, embed_dim, H, gen)
        self.actor = _mlp_layers([D + Z, H, num_actions], gen)
        self.critic = _mlp_layers([D + Z, H, 1], gen)
        self.to(resolve_device(device))

    # -- the latents -----------------------------------------------------

    def unimix(self, logits):
        """V3's 1% uniform mixture over latent classes (log-probabilities):
        keeps the categorical from saturating (stabilises the KL terms)."""
        return torch.log(0.99 * torch.softmax(logits, dim=-1)
                         + 0.01 / self.C)

    def sample_latent(self, logits, gumbel):
        """Straight-through one-hot sample per group -> flat [.., Z]: the
        class argmax(lg + gumbel) ([.., G, C] noise), its one-hot carrying
        the gradient of the probabilities."""
        lg = self.unimix(logits.reshape(*logits.shape[:-1], self.G, self.C))
        one = F.one_hot(torch.argmax(gumbel + lg.detach(), dim=-1),
                        self.C).to(lg.dtype)
        prob = torch.exp(lg)
        return (one + prob - prob.detach()).reshape(*logits.shape[:-1],
                                                     self.Z)

    def kl_cat(self, lhs_logits, rhs_logits):
        """KL( Cat(lhs) || Cat(rhs) ) summed over groups."""
        shape = lhs_logits.shape[:-1] + (self.G, self.C)
        lp = self.unimix(lhs_logits.reshape(shape))
        lq = self.unimix(rhs_logits.reshape(shape))
        return torch.sum(torch.exp(lp) * (lp - lq), dim=(-2, -1))

    # -- the world model -------------------------------------------------

    def observe(self, obs_seq, act_seq, gumbel):
        """Filter a [B, T, ...] batch through the RSSM (gumbel [T, B, G, C]).
        -> (h_seq, z_seq, post_logits, prior_logits), each [B, T, ..]."""
        wm = self.wm
        b, t = obs_seq.shape[:2]
        embed = _mlp(wm.enc, symlog(obs_seq))
        h = obs_seq.new_zeros((b, self.D))
        z = obs_seq.new_zeros((b, self.Z))
        out: Tuple[list, list, list, list] = ([], [], [], [])
        for i in range(t):
            h = wm.gru(h, torch.cat([z, act_seq[:, i]], -1))
            prior_lg = _mlp(wm.prior, h)
            post_lg = _mlp(wm.post, torch.cat([h, embed[:, i]], -1))
            z = self.sample_latent(post_lg, gumbel[i])
            for acc, v in zip(out, (h, z, post_lg, prior_lg)):
                acc.append(v)
        return tuple(torch.stack(acc, dim=1) for acc in out)

    def wm_loss(self, batch, gumbel, cfg):
        obs = batch["obs"]                       # [B, T, obs]
        acts = F.one_hot(batch["actions"], self.num_actions).to(obs.dtype)
        # h_t conditions on the PREVIOUS step's action (the one whose
        # transition ARRIVED at obs_t), as the acting path rolls h forward.
        acts_prev = torch.cat([torch.zeros_like(acts[:, :1]), acts[:, :-1]],
                              dim=1)
        hs, zs, post_lg, prior_lg = self.observe(obs, acts_prev, gumbel)
        feat = torch.cat([hs, zs], -1)
        recon = _mlp(self.wm.dec, feat)
        rew = _mlp(self.wm.rew, feat)[..., 0]
        cont_logit = _mlp(self.wm.cont, feat)[..., 0]
        l_rec = torch.mean(torch.sum((recon - symlog(obs)) ** 2, -1))
        l_rew = torch.mean((rew - symlog(batch["rewards"])) ** 2)
        l_cont = torch.mean(
            torch.clamp(cont_logit, min=0) - cont_logit * batch["cont"]
            + torch.log1p(torch.exp(-torch.abs(cont_logit))))
        # KL balance with free bits (V3): dyn pulls the prior to the
        # posterior, rep (small) the posterior toward the prior
        kl_dyn = torch.clamp(torch.mean(self.kl_cat(post_lg.detach(),
                                                    prior_lg)),
                             min=cfg["free_bits"])
        kl_rep = torch.clamp(torch.mean(self.kl_cat(post_lg,
                                                    prior_lg.detach())),
                             min=cfg["free_bits"])
        loss = (l_rec + l_rew + l_cont + cfg["kl_dyn_scale"] * kl_dyn
                + cfg["kl_rep_scale"] * kl_rep)
        return loss, (hs, zs, l_rec, l_rew, kl_dyn)

    # -- imagination -----------------------------------------------------

    def imagine(self, h, z, actor_gumbel, prior_gumbel):
        """Roll the PRIOR forward H steps with the actor (noise [H, N, A]
        and [H, N, G, C]). -> feats [H+1, N, D+Z], actions [H, N], logps,
        entropies. Only the actor's logits carry a gradient: the actions are
        one-hot draws, so nothing upstream depends on the actor."""
        feats, acts, lps, ents = [], [], [], []
        for i in range(actor_gumbel.shape[0]):
            feat = torch.cat([h, z], -1).detach()
            logits = _mlp(self.actor, feat)
            a = torch.argmax(actor_gumbel[i] + logits.detach(), dim=-1)
            lp_all = torch.log_softmax(logits, dim=-1)
            feats.append(feat)
            acts.append(a)
            lps.append(lp_all.gather(1, a[:, None])[:, 0])
            ents.append(-torch.sum(torch.exp(lp_all) * lp_all, -1))
            with torch.no_grad():
                a1 = F.one_hot(a, self.num_actions).to(h.dtype)
                h = self.wm.gru(h, torch.cat([z, a1], -1))
                z = self.sample_latent(_mlp(self.wm.prior, h),
                                       prior_gumbel[i])
        feats.append(torch.cat([h, z], -1).detach())
        return (torch.stack(feats), torch.stack(acts), torch.stack(lps),
                torch.stack(ents))

    def ac_losses(self, h0, z0, noise, cfg):
        """-> (actor loss, critic loss, mean lambda-return) of one
        imagination rollout from the states (h0, z0)."""
        feats, _, lps, ents = self.imagine(h0, z0, noise["actor"],
                                           noise["prior"])
        with torch.no_grad():
            rew = symexp(_mlp(self.wm.rew, feats)[1:, :, 0])
            cont = torch.sigmoid(_mlp(self.wm.cont, feats)[1:, :, 0])
        values = _mlp(self.critic, feats)[..., 0]
        rets = lambda_returns(rew, cont, values.detach(), cfg["gamma"],
                              cfg["gae_lambda"])
        # return normalisation (V3: scale by the range of percentiles)
        flat = rets.reshape(-1)
        scale = torch.clamp(torch.quantile(flat, 0.95)
                            - torch.quantile(flat, 0.05), min=1.0)
        adv = ((rets - values[:-1]) / scale).detach()
        actor_loss = (-torch.mean(lps * adv)
                      - cfg["entropy_coeff"] * torch.mean(ents))
        critic_loss = torch.mean((values[:-1] - rets) ** 2)
        return actor_loss, critic_loss, torch.mean(rets)

    # -- acting ----------------------------------------------------------

    @torch.no_grad()
    def policy_step(self, h, z, obs, gumbel):
        """Filtered acting in the real env (posterior latents); gumbel:
        {"post": [N, G, C], "action": [N, A]}. -> (h, z, action)."""
        emb = _mlp(self.wm.enc, symlog(obs))
        post_lg = _mlp(self.wm.post, torch.cat([h, emb], -1))
        z = self.sample_latent(post_lg, gumbel["post"])
        logits = _mlp(self.actor, torch.cat([h, z], -1))
        a = torch.argmax(gumbel["action"] + logits, dim=-1)
        a1 = F.one_hot(a, self.num_actions).to(h.dtype)
        h = self.wm.gru(h, torch.cat([z, a1], -1))
        return h, z, a


def lambda_returns(rew, cont, values, gamma: float, lam: float):
    """V3's bootstrapped lambda-return over imagined steps ([H, N] rewards
    and continues, [H+1, N] values): a reversed loop over H."""
    nxt = values[-1]
    rets = []
    for t in reversed(range(rew.shape[0])):
        nxt = rew[t] + gamma * cont[t] * ((1 - lam) * values[t + 1]
                                          + lam * nxt)
        rets.append(nxt)
    return torch.stack(rets[::-1])


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in [tiny, 1), as
    `jax.random.gumbel` draws it."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))


_CONFIG_KEYS = ("free_bits", "kl_dyn_scale", "kl_rep_scale", "gamma",
                "gae_lambda", "entropy_coeff")


class DreamerV3Learner:
    """The model and its three Adams (optax's defaults: b1 0.9, b2 0.999,
    eps 1e-8, no weight decay, no clip) with the jitted JAX `train_step`'s
    update order: the world model, then the actor against the updated world
    model and the old critic, then the critic against the updated actor,
    both critic and actor on the same imagination noise."""

    def __init__(self, model: DreamerModel, config: Dict[str, Any]):
        self.model = model
        self.cfg = {k: config[k] for k in _CONFIG_KEYS}
        self.horizon = config["horizon_H"]
        self.optimizers, self.opt_state, self._updates = {}, {}, {}
        for name, lr in (("wm", config["lr"]), ("actor", config["actor_lr"]),
                         ("critic", config["critic_lr"])):
            opt = AdamW(lr, weight_decay=0.0)
            self.optimizers[name] = opt
            self.opt_state[name] = opt.init(self._params(name))
            self._updates[name] = opt.updater()
        self._graph: Optional[_GraphedStep] = None

    def _params(self, name: str) -> List[torch.Tensor]:
        return list(getattr(self.model, name).parameters())

    def _step(self, name: str, loss: torch.Tensor) -> None:
        params = self._params(name)
        grads = torch.autograd.grad(loss, params)
        self._updates[name](list(grads), self.opt_state[name], params)

    def draw_noise(self, b: int, t: int, generator: torch.Generator
                   ) -> Dict[str, torch.Tensor]:
        """Gumbel noise for one train step: the posterior filter's
        [T, B, G, C], the imagination's actor [H, B*T, A] and prior
        [H, B*T, G, C]."""
        m, dev = self.model, next(self.model.parameters()).device
        n = b * t
        return {"post": gumbel((t, b, m.G, m.C), generator, dev),
                "actor": gumbel((self.horizon, n, m.num_actions), generator,
                                dev),
                "prior": gumbel((self.horizon, n, m.G, m.C), generator,
                                dev)}

    def train_step(self, batch: Dict[str, torch.Tensor],
                   noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update of the three parameter sets in place. -> the metrics
        as 0-d tensors on the device."""
        return self._train_step(batch, noise, self._step)

    def _train_step(self, batch, noise, step) -> Dict[str, torch.Tensor]:
        m = self.model
        wml, (hs, zs, l_rec, l_rew, kld) = m.wm_loss(batch, noise["post"],
                                                     self.cfg)
        step("wm", wml)
        # imagination starts from every posterior state in the batch
        h0 = hs.detach().reshape(-1, m.D)
        z0 = zs.detach().reshape(-1, m.Z)
        al, _, ret = m.ac_losses(h0, z0, noise, self.cfg)
        step("actor", al)
        _, cl, _ = m.ac_losses(h0, z0, noise, self.cfg)
        step("critic", cl)
        return {"wm_loss": wml, "recon_loss": l_rec, "reward_loss": l_rew,
                "kl_dyn": kld, "actor_loss": al, "critic_loss": cl,
                "imagined_return": ret}

    def train_step_graphed(self, batch: Dict[str, torch.Tensor],
                           noise: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
        """`train_step` on the card as one CUDA graph: the same kernels in
        the same order, replayed in one launch. Each call takes its one
        step: the first `_GraphedStep.WARMUP` calls eagerly (they set up
        cuBLAS's and autograd's lazy state), the next is captured and
        replayed, and every later one copies its batch and noise into the
        graph's inputs and replays it. The shapes must stay those of the
        first call. -> the metrics as 0-d tensors on the device, which the
        next call overwrites."""
        if self._graph is None:
            self._graph = _GraphedStep(self)
        return self._graph(batch, noise)


class _GraphedStep:
    """The learner's step captured as one CUDA graph. The graph holds the
    step's inputs (the batch and the noise), its metrics, and the three
    Adams' update counts as device tensors that it advances itself; the
    parameters and moments are updated in place, as eagerly. The host's
    counts (`opt_state[name].count`) follow each call."""

    WARMUP = 2

    def __init__(self, learner: DreamerV3Learner):
        self.learner = learner
        self.calls = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: Dict[str, Dict[str, torch.Tensor]] = {}
        self.outputs: Dict[str, torch.Tensor] = {}
        self.counts: Dict[str, torch.Tensor] = {}
        self.stream = torch.cuda.Stream()

    def _step(self, name: str, loss: torch.Tensor) -> None:
        """`DreamerV3Learner._step` with the update count on the device."""
        learner = self.learner
        params = learner._params(name)
        grads = list(torch.autograd.grad(loss, params))
        opt, state = learner.optimizers[name], learner.opt_state[name]
        count = self.counts[name]
        count.add_(1.0)
        _adamw_(params, grads, tree_leaves(state.mu), tree_leaves(state.nu),
                count, opt.learning_rate, opt.b1, opt.b2, opt.eps,
                opt.weight_decay)

    def __call__(self, batch, noise) -> Dict[str, torch.Tensor]:
        learner = self.learner
        self.calls += 1
        if self.calls <= self.WARMUP:
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                out = learner.train_step(batch, noise)
            torch.cuda.current_stream().wait_stream(self.stream)
            return out
        if self.graph is None:
            self.inputs = {
                "batch": {k: v.clone() for k, v in batch.items()},
                "noise": {k: v.clone() for k, v in noise.items()}}
            dev = next(learner.model.parameters()).device
            self.counts = {name: torch.full(
                (), float(state.count), dtype=torch.float32, device=dev)
                for name, state in learner.opt_state.items()}
            torch.cuda.synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=self.stream):
                self.outputs = learner._train_step(
                    self.inputs["batch"], self.inputs["noise"], self._step)
        else:
            for k, v in batch.items():
                self.inputs["batch"][k].copy_(v)
            for k, v in noise.items():
                self.inputs["noise"][k].copy_(v)
        self.graph.replay()
        for state in learner.opt_state.values():
            state.count += 1
        return self.outputs


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.long() if k == "actions" else t.float()).to(device)
    return out


class DreamerV3(Algorithm):
    def setup(self, config: DreamerV3Config) -> None:
        cfg = config
        self.device = resolve_device(cfg.device)
        self.env = make_env(cfg.env, cfg.env_config)
        obs_dim = int(self.env.observation_space.shape[0])
        num_actions = int(self.env.action_space.n)
        self.obs_dim, self.num_actions = obs_dim, num_actions
        self.model = DreamerModel(
            obs_dim, num_actions, deter_dim=cfg.deter_dim,
            stoch_groups=cfg.stoch_groups, stoch_classes=cfg.stoch_classes,
            embed_dim=cfg.embed_dim, hidden_dim=cfg.hidden_dim,
            generator=torch.Generator().manual_seed(cfg.seed or 0),
            device=self.device)
        self.learner = DreamerV3Learner(self.model, cfg.to_dict())
        self._gen = torch.Generator(device=self.device).manual_seed(
            (cfg.seed or 0) + 1)
        self._D, self._Z = self.model.D, self.model.Z
        self._reset_latents()
        self.buffer = _SeqBuffer(cfg.buffer_capacity)
        self.buffer.start_episode()
        self._rng = np.random.default_rng(cfg.seed)
        self._obs, _ = self.env.reset(seed=cfg.seed)
        self._ep_return = 0.0
        # arrival labels for the NEXT buffer entry (see _SeqBuffer)
        self._arrival_reward = 0.0
        self._arrival_cont = 1.0

    def _reset_latents(self) -> None:
        self._h = torch.zeros((1, self._D), device=self.device)
        self._z = torch.zeros((1, self._Z), device=self.device)

    def policy_step(self, obs: np.ndarray, noise=None) -> int:
        """One action for `obs` from the filtered latents, which it rolls
        forward. noise: {"post": [1, G, C], "action": [1, A]} (numpy or
        tensors), else drawn from the algorithm's generator."""
        m = self.model
        if noise is None:
            noise = {"post": gumbel((1, m.G, m.C), self._gen, self.device),
                     "action": gumbel((1, m.num_actions), self._gen,
                                      self.device)}
        noise = {k: torch.as_tensor(v, dtype=torch.float32,
                                    device=self.device)
                 for k, v in noise.items()}
        obs_t = torch.as_tensor(np.asarray(obs, np.float32)[None],
                                device=self.device)
        self._h, self._z, a = m.policy_step(self._h, self._z, obs_t, noise)
        return int(a[0])

    def train_step(self, batch: Dict[str, np.ndarray], noise=None
                   ) -> Dict[str, float]:
        """One update from a [B, T] batch of the buffer. noise: as
        `DreamerV3Learner.draw_noise` gives it (numpy or tensors), else
        drawn from the algorithm's generator."""
        b, t = batch["actions"].shape
        if noise is None:
            noise = self.learner.draw_noise(b, t, self._gen)
        noise = {k: torch.as_tensor(v, dtype=torch.float32,
                                    device=self.device)
                 for k, v in noise.items()}
        step = (self.learner.train_step_graphed
                if self.device.type == "cuda" else self.learner.train_step)
        out = step(_to_device(batch, self.device), noise)
        values = torch.stack([v.detach().float() for v in out.values()])
        return dict(zip(out, values.tolist()))

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        metrics: Dict[str, Any] = {}
        for _ in range(cfg.num_steps_per_iteration):
            action = self.policy_step(self._obs)
            # entry for the CURRENT obs: its chosen action + the arrival
            # labels stashed when we got here
            self.buffer.add(self._obs, action, self._arrival_reward,
                            self._arrival_cont)
            next_obs, reward, term, trunc, _ = self.env.step(action)
            self._arrival_reward = float(reward)
            self._arrival_cont = 0.0 if term else 1.0
            self._num_env_steps_sampled_lifetime += 1
            self._ep_return += float(reward)
            if term or trunc:
                # terminal/truncation ARRIVAL state (dummy action)
                self.buffer.add(next_obs, 0, self._arrival_reward,
                                self._arrival_cont)
                self._episode_returns.append(self._ep_return)
                self._ep_return = 0.0
                self.buffer.end_episode()
                self.buffer.start_episode()
                self._obs, _ = self.env.reset()
                self._arrival_reward = 0.0
                self._arrival_cont = 1.0
                self._reset_latents()
            else:
                self._obs = next_obs

        if (self._num_env_steps_sampled_lifetime
                >= cfg.num_steps_sampled_before_learning_starts):
            for _ in range(cfg.train_ratio):
                batch = self.buffer.sample(
                    self._rng, cfg.batch_size_B, cfg.batch_length_T)
                if batch is None:
                    break
                metrics = self.train_step(batch)
        metrics["buffer_size"] = self.buffer.size
        return metrics

    def get_state(self):
        return {"params": {k: v.detach().cpu() for k, v in
                           self.model.state_dict().items()},
                "counters": {
                    "env_steps": self._num_env_steps_sampled_lifetime}}

    def set_state(self, state):
        self.model.load_state_dict(state["params"])

    def stop(self) -> None:
        self.env.close()
