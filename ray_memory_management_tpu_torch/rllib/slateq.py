"""SlateQ: slate recommendation Q-learning with choice-model decomposition.

The reference's rllib/algorithms/slateq/ (Ie et al. 2019, paired with
RecSim's interest-evolution environment): the combinatorial action — a
SLATE of k documents out of N candidates — decomposes under a
single-choice user model into per-item values,

    Q(s, slate) = sum_{i in slate} P(click i | s, slate) * Qbar(s, i),

so only the ITEM-wise Qbar(s, d) must be learned (a |slate|-free
network), the TD backup weights next-slate item values by the choice
model's click probabilities, and slate construction is the standard
top-k-by-score greedy over v(s,d) * Qbar(s,d).

Every per-item evaluation batches — the update runs Qbar over [B, N]
candidate features in one forward (the MLP just sees a [B*N, feat]
matmul), the choice-model weighting and the decomposed backup are
tensor algebra on the learner's device, and acting scores all
candidates in one call. A compact interest-evolution env
(user interests drift toward clicked topics, engagement is the reward)
stands in for RecSim, with myopic-vs-long-term structure: clickbait
docs get clicks but erode the session, quality docs compound it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .algorithm import Algorithm, AlgorithmConfig
from .env import register_env
from .models import (
    apply_update, copy_into, detached_copy, make_adam, make_generator,
    mlp_apply, mlp_init, params_to_numpy, trainable,
)
from .ppo import stats_to_floats
from .replay import ReplayBuffer


class InterestEvolution:
    """Slate recommendation env (RecSim interest_evolution, reduced).

    - ``n_docs`` documents, each a unit topic vector + a quality scalar;
      low-quality docs are CLICKBAIT: higher click appeal, but clicking
      them drains the session budget with little engagement. High-quality
      docs engage long term (the myopic-vs-SlateQ tension the paper's
      experiments measure).
    - The user holds an interest vector; a click drifts it toward the
      clicked doc's topic.
    - Choice model: conditional logit over the slate + a no-click option
      (exp scores; exposed via :meth:`choice_scores` — SlateQ assumes
      the choice model is known/estimated, as the reference does).
    - obs = [user interests, all doc features flat] (fully observed doc
      corpus; the policy's job is slate COMPOSITION).
    """

    def __init__(self, n_docs: int = 20, n_topics: int = 6,
                 slate_size: int = 3, max_episode_steps: int = 20,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.n_docs = n_docs
        self.n_topics = n_topics
        self.slate_size = slate_size
        self.max_episode_steps = max_episode_steps
        topics = rng.standard_normal((n_docs, n_topics))
        self.doc_topics = (topics / np.linalg.norm(
            topics, axis=1, keepdims=True)).astype(np.float32)
        # quality in [0, 1]; appeal is anti-correlated (clickbait)
        self.doc_quality = rng.uniform(0, 1, n_docs).astype(np.float32)
        self.doc_appeal = (1.2 - self.doc_quality
                           + 0.2 * rng.standard_normal(n_docs)
                           ).astype(np.float32)
        self.doc_feats = np.concatenate(
            [self.doc_topics, self.doc_quality[:, None],
             self.doc_appeal[:, None]], axis=1)  # [N, n_topics+2]
        self.feat_dim = self.doc_feats.shape[1]
        self.observation_dim = n_topics + n_docs * self.feat_dim
        self._rng = rng
        self._interest = np.zeros(n_topics, np.float32)
        self._t = 0

    def _obs(self) -> np.ndarray:
        return np.concatenate(
            [self._interest, self.doc_feats.ravel()]).astype(np.float32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        v = self._rng.standard_normal(self.n_topics)
        self._interest = (v / np.linalg.norm(v)).astype(np.float32)
        self._t = 0
        return self._obs()

    def choice_scores(self, docs: np.ndarray) -> np.ndarray:
        """exp conditional-logit scores v(s, d) for given doc indices;
        the no-click option scores exp(0) = 1."""
        affinity = self.doc_topics[docs] @ self._interest
        return np.exp(affinity + self.doc_appeal[docs])

    def step(self, slate: List[int]):
        """slate: doc indices. Returns (obs, reward, term, trunc, info);
        info carries which doc was clicked (or -1)."""
        slate = list(slate)
        self._t += 1
        scores = self.choice_scores(np.asarray(slate))
        total = scores.sum() + 1.0  # + the no-click option
        probs = np.concatenate([scores / total, [1.0 / total]])
        pick = int(self._rng.choice(len(slate) + 1, p=probs))
        reward = 0.0
        clicked = -1
        if pick < len(slate):
            clicked = slate[pick]
            q = float(self.doc_quality[clicked])
            reward = q  # engagement tracks quality, not appeal
            # interests drift toward the clicked topic
            self._interest = (0.9 * self._interest
                              + 0.1 * self.doc_topics[clicked])
            self._interest /= max(np.linalg.norm(self._interest), 1e-6)
        trunc = self._t >= self.max_episode_steps
        return self._obs(), reward, False, trunc, {"clicked": clicked}


register_env("InterestEvolution", InterestEvolution)


def _slate_combos(pruned: int, k: int) -> np.ndarray:
    """All C(pruned, k) index combinations, as a static array — exact
    slate optimization over a pruned candidate set enumerates inside
    jit with fixed shapes (the paper optimizes slates exactly via an
    LP; over <=8 pruned candidates brute force is cheaper than either
    the LP or the top-k greedy's regret)."""
    from itertools import combinations

    return np.asarray(list(combinations(range(pruned), k)), np.int32)


def _best_slate_value(scores, q, combos, prune):
    """max over slates of sum(s_i q_i) / (sum s_i + 1): the decomposed
    slate value under the conditional-logit choice model (+1 = the
    no-click option). scores/q: [..., N]; combos: [C, k] index rows of
    the pruned top; returns (value, top indices, best combo row)."""
    # lax.top_k's order: descending, the lower index first among ties
    # (every doc with Qbar <= 0 ties at 0, and which of them is kept
    # changes the slate's value)
    top_idx = torch.sort(scores * torch.clamp(q, min=0.0), dim=-1,
                         descending=True, stable=True).indices[..., :prune]
    s_p = torch.gather(scores, -1, top_idx)               # [..., prune]
    q_p = torch.gather(q, -1, top_idx)
    s_c = s_p[..., combos]                                # [..., C, k]
    q_c = q_p[..., combos]
    v = (s_c * q_c).sum(-1) / (s_c.sum(-1) + 1.0)         # [..., C]
    best = v.argmax(-1)
    return torch.gather(v, -1, best[..., None])[..., 0], top_idx, best


def qbar_all(params, user, feats):
    """[B, n_topics] user x [B, N, feat] docs -> [B, N] item values."""
    B, N, _ = feats.shape
    u = user[:, None, :].expand(B, N, user.shape[-1])
    x = torch.cat([u, feats], -1).reshape(B * N, -1)
    return mlp_apply(params, x)[..., 0].reshape(B, N)


SLATEQ_COLUMNS = ("user", "clicked_feat", "rew", "nxt_user", "nxt_scores",
                  "done")


def make_slateq_update(opt, gamma: float):
    """The decomposed TD step: Qbar over all [B, N] candidates, exact
    pruned-combinatorial next-slate optimization, and the
    choice-probability-weighted backup (slateq.py's decomposed target;
    slate optimization exact rather than top-k greedy — greedy ranks by
    s*Q and seats clickbait rows whose high appeal STEALS probability
    mass from higher-value items, precisely this env's failure mode).
    ``update(params, target_params, feats, user, clicked_feat, rew,
    nxt_user, nxt_scores, done, combos, prune) -> stats``, in place;
    ``feats`` [B, N, feat] serves both the current and the next step."""

    def update(params, target_params, feats, user, clicked_feat, rew,
               nxt_user, nxt_scores, done, combos, prune):
        # target: value of the BEST next slate (exact over pruned set)
        with torch.no_grad():
            nq = qbar_all(target_params, nxt_user, feats)      # [B, N]
            v_next, _, _ = _best_slate_value(nxt_scores, nq, combos, prune)
            target = rew + gamma * (1.0 - done) * v_next
        # online: Qbar of the clicked item only (no-click transitions
        # carry zero reward and train nothing item-wise — slateq.py
        # likewise learns from click events)
        q = mlp_apply(params, torch.cat([user, clicked_feat], -1))[..., 0]
        loss = torch.mean((q - target) ** 2)
        apply_update(opt, loss)
        return {"td_loss": loss.detach(), "mean_q": q.detach().mean()}

    return update


class SlateQ(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        from .env import make_env

        self.cfg = config
        self.device = resolve_device(config.get("device"))
        seed = config.get("seed", 0)
        self.env = make_env(config["env_spec"], config.get("env_config"))
        if not hasattr(self.env, "choice_scores"):
            raise ValueError("SlateQ needs a slate env exposing the "
                             "user choice model (choice_scores)")
        self.n_docs = self.env.n_docs
        self.slate_size = self.env.slate_size
        self.feat_dim = self.env.feat_dim
        self.n_topics = self.env.n_topics
        hidden = config.get("hidden", (64, 64))
        self.params = trainable(mlp_init(
            make_generator(seed),
            [self.n_topics + self.feat_dim, *hidden, 1]), self.device)
        self.target_params = detached_copy(self.params)
        self.opt = make_adam(self.params, config.get("lr", 1e-3))
        self._update = make_slateq_update(self.opt,
                                          config.get("gamma", 0.95))
        self._prune = min(config.get("slate_prune", 8), self.n_docs)
        self._combos = _slate_combos(self._prune, self.slate_size)
        self._combos_dev = torch.as_tensor(self._combos, dtype=torch.long,
                                           device=self.device)
        self._feats_dev = torch.as_tensor(self.env.doc_feats,
                                          device=self.device)
        self.buffer = ReplayBuffer(config.get("buffer_size", 50_000))
        self.batch_size = config.get("train_batch_size", 128)
        self.updates_per_iter = config.get("updates_per_iter", 40)
        self.rollout_steps = config.get("rollout_fragment_length", 200)
        self.target_every = config.get("target_update_freq", 200)
        self.eps = config.get("epsilon", 1.0)
        self.eps_final = config.get("epsilon_final", 0.05)
        self.eps_steps = config.get("epsilon_timesteps", 2000)
        self._rng = np.random.default_rng(seed)
        self._obs_user = None
        self.env.reset(seed=seed)
        self._ep_reward = 0.0
        self.episode_rewards: List[float] = []
        self._timesteps_total = 0
        self._updates_done = 0
        self.workers = None
        self.local_worker = None

    # -------------------------------------------------------------- acting
    def _slate(self, explore: bool) -> List[int]:
        if explore and self._rng.random() < self._epsilon():
            return list(self._rng.choice(self.n_docs, self.slate_size,
                                         replace=False))
        dev = self.device
        interest = torch.as_tensor(self.env._interest, device=dev)
        scores = torch.as_tensor(
            self.env.choice_scores(np.arange(self.n_docs)), device=dev)
        with torch.no_grad():
            q = qbar_all(self.params, interest[None],
                         self._feats_dev[None])[0]
            _, top_idx, best = _best_slate_value(
                scores, q, self._combos_dev, self._prune)
            # one read back: the chosen combination's document indices
            slate = top_idx[self._combos_dev[best]].tolist()
        return [int(d) for d in slate]

    def _epsilon(self) -> float:
        frac = min(1.0, self._timesteps_total / self.eps_steps)
        return self.eps + frac * (self.eps_final - self.eps)

    # ------------------------------------------------------------- training
    def _collect(self, n: int) -> None:
        env = self.env
        cols = {k: [] for k in ("user", "clicked_feat", "rew", "nxt_user",
                                "nxt_scores", "done")}
        for _ in range(n):
            user = env._interest.copy()
            slate = self._slate(explore=True)
            _, r, term, trunc, info = env.step(slate)
            self._ep_reward += r
            self._timesteps_total += 1
            clicked = info["clicked"]
            if clicked >= 0:  # item-wise learning happens on clicks
                cols["user"].append(user)
                cols["clicked_feat"].append(env.doc_feats[clicked])
                cols["rew"].append(np.float32(r))
                cols["nxt_user"].append(env._interest.copy())
                cols["nxt_scores"].append(env.choice_scores(
                    np.arange(self.n_docs)).astype(np.float32))
                cols["done"].append(np.float32(1.0 if term else 0.0))
            if term or trunc:
                self.episode_rewards.append(self._ep_reward)
                self._ep_reward = 0.0
                env.reset(seed=int(self._rng.integers(1 << 31)))
        if cols["user"]:
            self.buffer.add_batch(
                {k: np.stack(v) for k, v in cols.items()})

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        self._collect(self.rollout_steps)
        stats = {}
        if len(self.buffer) >= self.batch_size:
            for _ in range(self.updates_per_iter):
                stats = self.learn_on_minibatch(
                    self.buffer.sample(self.batch_size))
        recent = self.episode_rewards[-20:]
        return {
            "episode_reward_mean": float(np.mean(recent)) if recent
            else float("nan"),
            "epsilon": self._epsilon(),
            "num_updates": self._updates_done,
            **stats_to_floats(stats),
            "time_this_iter_s": time.time() - t0,
        }

    def learn_on_minibatch(self, cols: Dict[str, np.ndarray]
                           ) -> Dict[str, Any]:
        B = len(cols["rew"])
        feats = self._feats_dev[None].expand(B, -1, -1)
        stats = self._update(
            self.params, self.target_params, feats,
            *(torch.as_tensor(cols[k], device=self.device)
              for k in SLATEQ_COLUMNS),
            self._combos_dev, self._prune)
        self._updates_done += 1
        if self._updates_done % self.target_every == 0:
            copy_into(self.target_params, self.params)
        return stats

    def _episode_metrics(self) -> Dict[str, Any]:
        recent = self.episode_rewards[-50:]
        return {
            "episode_reward_mean": float(np.mean(recent)) if recent
            else None,
            "episode_len_mean": None,
            "episodes_total": len(self.episode_rewards),
        }

    def compute_slate(self) -> List[int]:
        """Greedy slate for the env's CURRENT user state."""
        return self._slate(explore=False)

    def _sync_weights(self) -> None:
        pass  # local rollouts

    def _save_extra_state(self):
        return {"params": params_to_numpy(self.params),
                "updates": self._updates_done,
                "steps": self._timesteps_total}

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        self.set_weights(state["params"])
        copy_into(self.target_params, self.params)
        self.opt.state.clear()
        self._updates_done = state.get("updates", 0)
        self._timesteps_total = state.get("steps", 0)


class SlateQConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(SlateQ)
        self.env_spec = "InterestEvolution"
        self.train_batch_size = 128
        self.extra.update({
            "updates_per_iter": 40, "target_update_freq": 200,
            "epsilon": 1.0, "epsilon_final": 0.05,
            "epsilon_timesteps": 2000, "buffer_size": 50_000,
        })

    def training(self, *, updates_per_iter=None, target_update_freq=None,
                 epsilon_timesteps=None, **kwargs) -> "SlateQConfig":
        super().training(**kwargs)
        for k, v in (("updates_per_iter", updates_per_iter),
                     ("target_update_freq", target_update_freq),
                     ("epsilon_timesteps", epsilon_timesteps)):
            if v is not None:
                self.extra[k] = v
        return self
