"""AlphaZero: MCTS-guided self-play policy/value learning.

The reference's rllib/algorithms/alpha_zero/ (mcts.py PUCT search +
alpha_zero_policy.py self-play training on a perfect-information env)
restructured around batched evaluation: the reference expands ONE leaf
per network call; here self-play runs N games in lockstep and every
MCTS simulation wave evaluates ALL games' leaves in ONE forward pass
(shape [n_games, obs]) — a [64, obs] matmul costs the card what a
[1, obs] one does. The tree itself stays host numpy (irregular,
data-dependent), mirroring how production AlphaZero splits search (host)
from evaluation (accelerator): each wave's leaves cross to the learner's
device in one copy and their priors and values come back in one.

Training is one step on the learner's device: cross-entropy of the
policy head against MCTS visit distributions + MSE of the value head
against final game outcomes (the AlphaZero loss), over minibatches from a
replay window.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .algorithm import Algorithm, AlgorithmConfig
from .models import (
    apply_update, make_adam, make_generator, mlp_apply, mlp_init,
    trainable, tree_leaves,
)
from .ppo import stats_to_floats


class TicTacToe:
    """Perfect-information benchmark game (two players, 3x3).

    Board: 9 cells in {0 empty, +1, -1}; the CURRENT player always sees
    the board from their own perspective (their stones are +1), so one
    network plays both sides — the AlphaZero convention."""

    n_actions = 9
    obs_dim = 9

    _LINES = np.array([
        [0, 1, 2], [3, 4, 5], [6, 7, 8],
        [0, 3, 6], [1, 4, 7], [2, 5, 8],
        [0, 4, 8], [2, 4, 6],
    ])

    def __init__(self):
        self.board = np.zeros(9, np.int8)
        self.player = 1

    def clone(self) -> "TicTacToe":
        g = TicTacToe.__new__(TicTacToe)
        g.board = self.board.copy()
        g.player = self.player
        return g

    def obs(self) -> np.ndarray:
        return (self.board * self.player).astype(np.float32)

    def legal(self) -> np.ndarray:
        return self.board == 0

    def step(self, a: int) -> None:
        assert self.board[a] == 0
        self.board[a] = self.player
        self.player = -self.player

    def outcome(self) -> Optional[int]:
        """None while running; else +1/-1 (winner's stone) or 0 draw."""
        sums = self.board[self._LINES].sum(axis=1)
        if (sums == 3).any():
            return 1
        if (sums == -3).any():
            return -1
        if (self.board != 0).all():
            return 0
        return None


class _Node:
    __slots__ = ("prior", "visits", "value_sum", "children", "legal")

    def __init__(self, prior: np.ndarray, legal: np.ndarray):
        self.prior = prior
        self.visits = np.zeros(len(prior), np.int32)
        self.value_sum = np.zeros(len(prior), np.float64)
        self.children: Dict[int, "_Node"] = {}
        self.legal = legal


def _puct_pick(node: _Node, c_puct: float) -> int:
    """argmax over legal actions of Q + c * P * sqrt(N) / (1 + n)."""
    n_total = node.visits.sum()
    q = np.where(node.visits > 0,
                 node.value_sum / np.maximum(node.visits, 1), 0.0)
    u = c_puct * node.prior * np.sqrt(n_total + 1) / (1.0 + node.visits)
    score = np.where(node.legal, q + u, -np.inf)
    return int(score.argmax())


class BatchedMCTS:
    """PUCT search over N games in lockstep: each simulation wave walks
    every game's tree to a leaf (host-side numpy), then evaluates ALL
    leaves in one batched network call (mcts.py's per-leaf evaluation,
    re-scheduled for the accelerator)."""

    def __init__(self, evaluate, n_sims: int, c_puct: float = 1.5,
                 dirichlet_alpha: float = 0.6,
                 dirichlet_frac: float = 0.25,
                 rng: Optional[np.random.Generator] = None):
        self.evaluate = evaluate  # [B, obs] -> (priors [B, A], values [B])
        self.n_sims = n_sims
        self.c_puct = c_puct
        self.alpha = dirichlet_alpha
        self.frac = dirichlet_frac
        self.rng = rng or np.random.default_rng(0)

    def _root(self, game, add_noise: bool) -> _Node:
        priors, _ = self.evaluate(game.obs()[None, :])
        p = np.asarray(priors[0], np.float64)
        legal = game.legal()
        p = np.where(legal, p, 0.0)
        p /= max(p.sum(), 1e-9)
        if add_noise:
            noise = self.rng.dirichlet([self.alpha] * int(legal.sum()))
            full = np.zeros_like(p)
            full[np.flatnonzero(legal)] = noise
            p = (1 - self.frac) * p + self.frac * full
        return _Node(p, legal)

    def search_batch(self, games: List, add_noise: bool = True
                     ) -> List[np.ndarray]:
        """Visit-count distributions for each game's root."""
        roots = [self._root(g, add_noise) for g in games]
        for _ in range(self.n_sims):
            leaves = []      # (game idx, path, leaf game or None terminal)
            for gi, (g, root) in enumerate(zip(games, roots)):
                sim = g.clone()
                node = root
                path: List[Tuple[_Node, int]] = []
                value = None
                while True:
                    a = _puct_pick(node, self.c_puct)
                    path.append((node, a))
                    sim.step(a)
                    out = sim.outcome()
                    if out is not None:
                        # terminal: exact value, no evaluation needed.
                        # `out` is in stone units; convert to the value
                        # FROM THE PERSPECTIVE of the player to move at
                        # the leaf, then back up the path
                        value = 0.0 if out == 0 else \
                            (1.0 if out == sim.player else -1.0)
                        break
                    child = node.children.get(a)
                    if child is None:
                        break  # unexpanded leaf: queue for batched eval
                    node = child
                leaves.append((gi, path, None if value is not None
                               else sim, value))
            # ONE network call for every unexpanded leaf this wave
            pend = [(i, item) for i, item in enumerate(leaves)
                    if item[2] is not None]
            if pend:
                obs = np.stack([item[2].obs() for _, item in pend])
                priors, values = self.evaluate(obs)
                priors = np.asarray(priors, np.float64)
                values = np.asarray(values, np.float64)
                for k, (i, (gi, path, sim, _)) in enumerate(pend):
                    legal = sim.legal()
                    p = np.where(legal, priors[k], 0.0)
                    p /= max(p.sum(), 1e-9)
                    parent, a = path[-1]
                    parent.children[a] = _Node(p, legal)
                    leaves[i] = (gi, path, sim, float(values[k]))
            # back up: value is from the leaf player's perspective;
            # alternate sign walking up (two-player zero-sum)
            for gi, path, sim, value in leaves:
                v = value
                for node, a in reversed(path):
                    v = -v  # parent player is the opponent of the child
                    node.visits[a] += 1
                    node.value_sum[a] += v
        return [r.visits.astype(np.float64) / max(r.visits.sum(), 1)
                for r in roots]


def az_heads(params, obs):
    """(policy logits [B, A], values [B] in [-1, 1])."""
    logits = mlp_apply(params["torso_pi"], obs)
    v = torch.tanh(mlp_apply(params["torso_v"], obs))[..., 0]
    return logits, v


def make_az_update(opt, l2: float):
    """``update(params, obs, target_pi, target_v) -> stats``: one Adam
    step of the AlphaZero loss in place."""

    def update(params, obs, target_pi, target_v):
        logits, v = az_heads(params, obs)
        logp = torch.log_softmax(logits, dim=-1)
        pi_loss = -torch.mean(torch.sum(target_pi * logp, dim=-1))
        v_loss = torch.mean((v - target_v) ** 2)
        reg = sum(torch.sum(w * w) for w in tree_leaves(params))
        total = pi_loss + v_loss + l2 * reg
        apply_update(opt, total)
        return {"policy_loss": pi_loss.detach(), "value_loss": v_loss.detach(),
                "total_loss": total.detach()}

    return update


class AlphaZero(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        self.cfg = config
        self.device = resolve_device(config.get("device"))
        seed = config.get("seed", 0)
        game_cls = config.get("game", TicTacToe)
        self.game_cls = game_cls
        hidden = config.get("hidden", (64,))
        gen = make_generator(seed)
        self.params = trainable({
            "torso_pi": mlp_init(
                gen, [game_cls.obs_dim, *hidden, game_cls.n_actions]),
            "torso_v": mlp_init(gen, [game_cls.obs_dim, *hidden, 1]),
        }, self.device)
        self.opt = make_adam(self.params, config.get("lr", 3e-3))
        self._update = make_az_update(self.opt,
                                      config.get("l2_coeff", 1e-4))
        self._rng = np.random.default_rng(seed)
        self.n_sims = config.get("num_simulations", 32)
        self.games_per_iter = config.get("games_per_iter", 32)
        self.batch_size = config.get("train_batch_size", 128)
        self.sgd_iters = config.get("num_sgd_iter", 8)
        self.temp_moves = config.get("temperature_moves", 4)
        self.window: List[tuple] = []   # (obs, pi, z)
        self.window_size = config.get("replay_window", 4096)
        self._timesteps_total = 0
        self._updates_done = 0
        self.evaluations = 0
        self.workers = None
        self.local_worker = None
        self.episode_rewards: list = []

    # ------------------------------------------------------------- network
    @torch.no_grad()
    def _evaluate(self, obs: np.ndarray):
        """One batched leaf evaluation: the leaves cross to the device in
        one copy; (priors [B, A], values [B]) come back as numpy."""
        self.evaluations += 1
        o = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        logits, v = az_heads(self.params, o)
        out = torch.cat([torch.softmax(logits, dim=-1), v[:, None]], -1)
        out = out.cpu().numpy()
        return out[:, :-1], out[:, -1]

    # ------------------------------------------------------------ self-play
    def _self_play(self) -> None:
        mcts = BatchedMCTS(self._evaluate, self.n_sims,
                           c_puct=self.cfg.get("c_puct", 1.5),
                           rng=self._rng)
        games = [self.game_cls() for _ in range(self.games_per_iter)]
        halves: List[List[tuple]] = [[] for _ in games]  # (obs, pi, player)
        results = [None] * len(games)
        move_no = 0
        live = list(range(len(games)))
        while live:
            dists = mcts.search_batch([games[i] for i in live])
            for k, i in enumerate(list(live)):
                g = games[i]
                pi = dists[k]
                halves[i].append((g.obs().copy(), pi.copy(), g.player))
                if move_no < self.temp_moves:
                    a = int(self._rng.choice(len(pi), p=pi))
                else:
                    a = int(pi.argmax())
                g.step(a)
                out = g.outcome()
                if out is not None:
                    results[i] = out
                    live.remove(i)
            move_no += 1
        for i, g in enumerate(games):
            z = results[i]
            for obs, pi, player in halves[i]:
                # outcome from the acting player's perspective
                zp = 0.0 if z == 0 else (1.0 if z == player else -1.0)
                self.window.append((obs, pi, zp))
            self._timesteps_total += len(halves[i])
            self.episode_rewards.append(float(z))
        if len(self.window) > self.window_size:
            self.window = self.window[-self.window_size:]

    # ------------------------------------------------------------- training
    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        self._self_play()
        stats = {}
        n = len(self.window)
        dev = self.device
        for _ in range(self.sgd_iters):
            idx = self._rng.integers(0, n, size=min(self.batch_size, n))
            obs = torch.as_tensor(
                np.stack([self.window[i][0] for i in idx]), device=dev)
            tpi = torch.as_tensor(
                np.stack([self.window[i][1] for i in idx]),
                dtype=torch.float32, device=dev)
            tv = torch.as_tensor(np.asarray(
                [self.window[i][2] for i in idx], np.float32), device=dev)
            stats = self._update(self.params, obs, tpi, tv)
            self._updates_done += 1
        return {
            "episodes_this_iter": self.games_per_iter,
            "replay_window": n,
            "num_updates": self._updates_done,
            **stats_to_floats(stats),
            "time_this_iter_s": time.time() - t0,
        }

    def _episode_metrics(self) -> Dict[str, Any]:
        recent = self.episode_rewards[-200:]
        return {
            "episode_reward_mean": float(np.mean(recent)) if recent
            else None,
            "episode_len_mean": None,
            "episodes_total": len(self.episode_rewards),
        }

    # ------------------------------------------------------------ inference
    def compute_single_action(self, game, greedy_sims: int = 0) -> int:
        """Best move for ``game`` (a live game object): raw policy argmax,
        or a noise-free MCTS when ``greedy_sims`` > 0."""
        if greedy_sims:
            mcts = BatchedMCTS(self._evaluate, greedy_sims,
                               rng=self._rng)
            pi = mcts.search_batch([game], add_noise=False)[0]
            legal_pi = np.where(game.legal(), pi, -np.inf)
            return int(legal_pi.argmax())
        priors, _ = self._evaluate(game.obs()[None, :])
        p = np.where(game.legal(), priors[0], -np.inf)
        return int(p.argmax())

    def _sync_weights(self) -> None:
        pass  # self-play runs in-process

    def _save_extra_state(self):
        return {"params": self.get_weights(),
                "updates": self._updates_done}

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        self.set_weights(state["params"])
        self.opt.state.clear()  # afresh, as the JAX learner's on restore
        self._updates_done = state.get("updates", 0)


class AlphaZeroConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(AlphaZero)
        self.extra.update({
            "num_simulations": 32, "games_per_iter": 32,
            "num_sgd_iter": 8, "temperature_moves": 4,
            "replay_window": 4096, "c_puct": 1.5, "l2_coeff": 1e-4,
        })

    def training(self, *, num_simulations=None, games_per_iter=None,
                 num_sgd_iter=None, replay_window=None,
                 **kwargs) -> "AlphaZeroConfig":
        super().training(**kwargs)
        for k, v in (("num_simulations", num_simulations),
                     ("games_per_iter", games_per_iter),
                     ("num_sgd_iter", num_sgd_iter),
                     ("replay_window", replay_window)):
            if v is not None:
                self.extra[k] = v
        return self
