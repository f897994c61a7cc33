"""The port's command-line tools, one module per tool of the repository's
``tools/``: ``python -m season_nerf_torch.tools.<name>``."""
