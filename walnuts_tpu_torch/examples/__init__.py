"""The port's example harnesses (``python -m
walnuts_tpu_torch.examples.<name>``), each the counterpart of the JAX
package's ``examples/<name>.py``."""
