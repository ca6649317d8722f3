"""CLI applications (reference L4): annonet_train / annonet_infer entry
points with every reference flag name and default (SURVEY.md §5), plus the
batch-size autotuner.

Run as modules:
    python -m annonet_jax.cli.train  <input-directory> [flags]
    python -m annonet_jax.cli.infer  <input-directory> [flags]
    python -m annonet_jax.cli.autotune <input-directory> [flags]
"""
