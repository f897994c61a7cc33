"""Serve a trained model directory as an HTTP render service.

    python -m season_nerf_torch.tools.serve_render \\
        --Model_Location ./io/Logs/demo --port 8642 [--device cpu]

The counterpart of ``tools/serve_render.py``: ``render/serving.py``'s
``main``, with its flags.  Endpoints: ``/healthz``, ``/info``,
``/render?view_el=&view_az=&sun_el=&sun_az=&t=&size=&layer=`` and
``/dsm?size=&format=npy|png``.  Frames render on the card (K3) unless
``--device cpu``.
"""

from season_nerf_torch.render.serving import main

if __name__ == "__main__":
    main()
