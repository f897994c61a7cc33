"""Convert a reference PyTorch checkpoint (a ``Final_Model.nn`` state dict
of the reference Season-NeRF, or a pickled module) into the port's
``Final_Model.nn`` artifact, the format both packages read:

    python -m season_nerf_torch.tools.convert_reference_model \
        --torch_model ref/Final_Model.nn --fc_units 512 --n_classes 4 \
        --out my_dir/Final_Model.nn

The counterpart of ``tools/convert_reference_model.py``, with its flags and
``meta``.  Like it, it writes no ``opts.json``: a model directory needs one
beside the artifact (one without ``compute_dtype``/``fast_sine`` loads as a
float32 model with the exact sine, as the reference trained it).
"""

from __future__ import annotations

import argparse

import torch

from season_nerf_torch.models.tnerf import TNeRF
from season_nerf_torch.train.state import save_model_artifact
from season_nerf_torch.utils.torch_convert import load_reference_checkpoint


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--torch_model", required=True)
    p.add_argument("--fc_units", type=int, default=512)
    p.add_argument("--n_classes", type=int, default=4)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    with torch.device("meta"):          # the template's shapes alone
        template = TNeRF(layer_width=args.fc_units,
                         n_classes=args.n_classes).state_dict()
    sd = load_reference_checkpoint(args.torch_model, template)
    save_model_artifact(args.out, sd,
                        meta={"fc_units": args.fc_units,
                              "n_classes": args.n_classes,
                              "converted_from": args.torch_model})
    print("wrote", args.out)


if __name__ == "__main__":
    main()
