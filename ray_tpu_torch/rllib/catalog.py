"""Model catalog: observation/action-space-driven module construction.

Reference: ray rllib/core/models/catalog.py (Catalog —
``_get_encoder_config`` picks CNN/MLP/flatten by space shape; heads are
built to match the action distribution). Here the catalog emits a
SERIALIZABLE module_spec (a dict) because env runners and learners are
separate actors: each side rebuilds the module from the spec via
``resolve_module``.

Encoder selection by observation space (gym duck-typing):
  Discrete(n)            -> one-hot(n) -> MLP
  Box shape (d,)         -> MLP
  Box shape (H, W, C)    -> Nature-CNN conv stack
  Box other ndim         -> flatten -> MLP
  Dict/Tuple             -> per-leaf flatten/one-hot -> concat -> MLP
                            (leaves must be Box/Discrete; nested composites
                            flatten recursively)

Action-space handling:
  Discrete(n)            -> categorical logits head (actor-critic / Q)
  Box shape (d,)         -> tanh-squashed diagonal Gaussian head

The port's copy of `ray_tpu/rllib/catalog.py` (which imports no JAX; the
port imports nothing of `ray_tpu`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

DEFAULT_CONV_FILTERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


def _is_discrete(space) -> bool:
    return hasattr(space, "n") and not hasattr(space, "spaces")


def _is_composite(space) -> bool:
    return hasattr(space, "spaces")


def _leaf_encoding(space) -> Tuple[str, Any]:
    """-> ("onehot", n) | ("flatten", flat_dim) for a composite leaf."""
    if _is_discrete(space):
        return ("onehot", int(space.n))
    if hasattr(space, "shape"):
        size = 1
        for d in space.shape:
            size *= int(d)
        return ("flatten", size)
    raise ValueError(f"unsupported leaf space: {space!r}")


class Catalog:
    """Builds module specs from spaces + model_config (fcnet_hiddens,
    post_fcnet_hiddens, conv_filters — the reference's model-config keys).
    """

    def __init__(self, observation_space, action_space,
                 model_config: Optional[Dict[str, Any]] = None):
        self.observation_space = observation_space
        self.action_space = action_space
        self.model_config = dict(model_config or {})

    # -- encoder -------------------------------------------------------------

    def encoder_spec(self) -> Dict[str, Any]:
        space = self.observation_space
        if _is_discrete(space):
            return {"kind": "onehot", "n": int(space.n)}
        if _is_composite(space):
            spaces = space.spaces
            if isinstance(spaces, dict):
                leaves = [(k, self._leaf_spec(s))
                          for k, s in sorted(spaces.items())]
                return {"kind": "concat", "container": "dict",
                        "leaves": leaves}
            leaves = [(i, self._leaf_spec(s)) for i, s in enumerate(spaces)]
            return {"kind": "concat", "container": "tuple", "leaves": leaves}
        shape = tuple(int(d) for d in space.shape)
        if len(shape) == 3:
            return {"kind": "cnn", "obs_shape": shape,
                    "conv_filters": tuple(tuple(f) for f in
                                          self.model_config.get(
                                              "conv_filters",
                                              DEFAULT_CONV_FILTERS))}
        if len(shape) == 1:
            return {"kind": "mlp", "obs_dim": shape[0]}
        size = 1
        for d in shape:
            size *= d
        return {"kind": "flatten", "obs_dim": size, "obs_shape": shape}

    def _leaf_spec(self, space):
        if _is_composite(space):
            # nested composite: flatten recursively leaf by leaf
            sub = Catalog(space, self.action_space,
                          self.model_config).encoder_spec()
            return sub
        kind, arg = _leaf_encoding(space)
        return ({"kind": "onehot", "n": arg} if kind == "onehot"
                else {"kind": "flatten", "obs_dim": arg})

    @staticmethod
    def encoded_dim(enc: Dict[str, Any]) -> int:
        """Flat feature width an encoder feeds into the dense stack (CNN
        excluded — its width is computed by the conv module itself)."""
        kind = enc["kind"]
        if kind == "onehot":
            return enc["n"]
        if kind in ("mlp", "flatten"):
            return enc["obs_dim"]
        if kind == "concat":
            return sum(Catalog.encoded_dim(leaf)
                       for _key, leaf in enc["leaves"])
        raise ValueError(f"no flat width for encoder {kind!r}")

    # -- module specs --------------------------------------------------------

    def _hiddens(self, default=(64, 64)) -> tuple:
        return tuple(self.model_config.get("fcnet_hiddens", default))

    def actor_critic_spec(self) -> Dict[str, Any]:
        """Spec for PPO/IMPALA/APPO-family modules."""
        enc = self.encoder_spec()
        if not _is_discrete(self.action_space):
            raise ValueError(
                "actor-critic catalog currently supports Discrete action "
                "spaces (continuous control goes through SAC's Gaussian "
                "actor — sac_specs())")
        num_actions = int(self.action_space.n)
        if enc["kind"] == "cnn":
            return {
                "module_class":
                    "ray_tpu_torch.rllib.rl_module:ConvActorCriticModule",
                "obs_shape": enc["obs_shape"], "num_actions": num_actions,
                "conv_filters": enc["conv_filters"],
                "hiddens": tuple(self.model_config.get(
                    "post_fcnet_hiddens", (512,))),
            }
        if enc["kind"] == "mlp":
            return {"obs_dim": enc["obs_dim"], "num_actions": num_actions,
                    "hiddens": self._hiddens()}
        return {
            "module_class":
                "ray_tpu_torch.rllib.rl_module:EncodedActorCriticModule",
            "module_kwargs": {"encoder_spec": enc,
                              "num_actions": num_actions,
                              "hiddens": self._hiddens()},
        }

    def q_spec(self) -> Dict[str, Any]:
        """Spec for DQN-family Q-modules."""
        enc = self.encoder_spec()
        if not _is_discrete(self.action_space):
            raise ValueError("Q catalog requires a Discrete action space")
        num_actions = int(self.action_space.n)
        if enc["kind"] == "cnn":
            raise ValueError(
                "image-observation DQN is not wired yet; use PPO/IMPALA's "
                "conv path or flatten the observation")
        obs_dim = self.encoded_dim(enc)
        spec = {"obs_dim": obs_dim, "num_actions": num_actions,
                "hiddens": self._hiddens(),
                "module_class": "ray_tpu_torch.rllib.rl_module:QModule"}
        if enc["kind"] != "mlp":
            spec["module_class"] = (
                "ray_tpu_torch.rllib.rl_module:EncodedQModule")
            spec["module_kwargs"] = {"encoder_spec": enc,
                                     "num_actions": num_actions,
                                     "hiddens": self._hiddens()}
        return spec

    def sac_specs(self) -> Dict[str, Any]:
        """(actor, critic) dims for SAC's Gaussian actor + Q critics."""
        enc = self.encoder_spec()
        if _is_discrete(self.action_space):
            raise ValueError("SAC catalog requires a Box action space")
        act_dim = int(self.action_space.shape[0])
        return {"obs_dim": self.encoded_dim(enc), "act_dim": act_dim,
                "hiddens": tuple(self.model_config.get(
                    "fcnet_hiddens", (256, 256)))}

    @classmethod
    def from_env(cls, env_id: str, env_config: Optional[dict] = None,
                 model_config: Optional[dict] = None) -> "Catalog":
        from ray_tpu_torch.rllib.envs import make_env

        env = make_env(env_id, env_config)
        try:
            return cls(env.observation_space, env.action_space, model_config)
        finally:
            env.close()
