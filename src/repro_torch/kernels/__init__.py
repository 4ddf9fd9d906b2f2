"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

* ``lif_update``    -- fused neuron state update (the *update* phase)
* ``spike_deliver`` -- delay-resolved gather delivery (the *deliver* phase)
* ``superstep_lif`` / ``superstep_iaf`` -- the fused D-cycle window (``cycle``)
* ``flash_attention`` -- causal GQA attention of the LM stack
* ``event_deliver`` -- the event backend's scatter of fired sources'
  outgoing synapses (plain jnp in the JAX package)

``ops`` holds the device-dispatching wrappers, ``ref`` the oracles used by
the tests, and ``cuda`` the build, load and launch-count machinery.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
