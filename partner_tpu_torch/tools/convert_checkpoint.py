"""Reference (det3d) ``.pth`` -> a port checkpoint (counterpart of
``tools/convert_checkpoint.py``).

    python -m partner_tpu_torch.tools.convert_checkpoint in.pth out_dir
        [--layer_nums 5 5] [--us_strides 1 2]

Loads the torch checkpoint on the CPU (``{"state_dict": ...}`` or a bare
state_dict; DDP ``module.`` prefixes are dropped), maps its RPN neck and,
where present, its SpMiddleResNetFHD backbone through
:mod:`partner_tpu_torch.train.torch_convert`, and writes a port checkpoint
(``out_dir/ckpt_00000000/state.pt``, ``meta.json`` with
``converted_from``, and ``out_dir/latest``), the sections the JAX tool
writes. ``train.checkpoint.load_checkpoint`` reads it and ``tools.train
--load_from`` (``load_parameters``) loads it. A backbone that lacks a key
is skipped with a message, as in the JAX tool. A ``.pth`` is a pickle:
convert only files from a source you trust.
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("input")
    p.add_argument("out_dir")
    p.add_argument("--layer_nums", nargs="*", type=int, default=[5, 5])
    p.add_argument("--us_strides", nargs="*", type=int, default=[1, 2])
    return p.parse_args(argv)


def main(argv=None):
    """-> the step directory written."""
    args = parse_args(argv)
    import torch

    from ..train import torch_convert as tc
    from ..train.checkpoint import save_checkpoint

    payload = torch.load(args.input, map_location="cpu", weights_only=False)
    sd = tc.strip_module_prefix(payload.get("state_dict", payload))
    out, sections = {}, []
    neck_sd = tc.sub_state_dict(sd, "neck.")
    if neck_sd:
        out.update(tc.prefixed("neck", tc.convert_rpn_state_dict(
            neck_sd, args.layer_nums, args.us_strides)))
        sections.append("neck")
    bb_sd = tc.sub_state_dict(sd, "backbone.")
    if bb_sd:
        try:
            out.update(tc.prefixed("backbone",
                                   tc.convert_backbone_state_dict(bb_sd)))
            sections.append("backbone")
        except KeyError as e:
            print(f"backbone conversion skipped (missing key {e})")
    path = save_checkpoint(args.out_dir, 0, out,
                           meta={"converted_from": args.input})
    print(f"converted {len(sd)} torch tensors -> {args.out_dir} "
          f"(sections: {sorted(sections)})")
    return path


if __name__ == "__main__":
    main()
