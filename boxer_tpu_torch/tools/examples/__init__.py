"""Worked examples of the port's entry points, each runnable with
`python -m boxer_tpu_torch.tools.examples.<name>`."""
