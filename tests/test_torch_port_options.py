"""The port's ``cli/options.parse_args`` against the JAX package's: the same
argv lists (the command lines of ``tests/test_cli.py`` and every runnable
command of ``docs/RECIPES.md`` and ``docs/MIGRATION.md``, extracted as
``tests/test_cli.py:134`` extracts them) give equal ``dataclasses.asdict``
of the two Configs, and the two parsers hold the same actions (option
strings, dest, default, type, choices) in the same order."""

import dataclasses
import os
import re

import pytest

from deep_video_interpolation_extrapolation_tpu.cli import options as joptions
from deep_video_interpolation_extrapolation_tpu_torch.cli import options

DOCS = os.path.join(os.path.dirname(__file__), "..", "docs")


def _doc_commands():
    cmds = []
    for name in ("RECIPES.md", "MIGRATION.md"):
        text = open(os.path.join(DOCS, name)).read()
        for block in re.findall(r"```bash\n(.*?)```", text, re.S):
            for line in block.replace("\\\n", " ").splitlines():
                line = line.strip()
                if line.startswith("python main.py") and "..." not in line:
                    cmds.append(re.sub(r"<[^>]*>", "1",
                                       line[len("python main.py"):]).strip())
    return cmds


ARGVS = [
    "INTER",
    "--syn_type extra EXTRA --model ExtraNet --train_coarse "
    "--num_pred_step 2",
    "INTER --model InterGANNet --vae --gan --frame_disc --frame_disc_lr 0.002 "
    "--frame_disc_d_w 0.5",
    "--dataset cityscape --split train --interval 5 --bs 16 --epochs 30 --s 1 "
    "--l1_w 80 --gdl_w 80 --vgg_w 20 --ce_w 30 --ssim_w 20 INTER --model "
    "InterRefineNet --refine --refine_model SRNRefine --n_sc 2 --train_coarse "
    "--train_refine --coarse_lr 0.001 --refine_lr 0.001",
    "--dataset synthetic --split train --syn_type inter --input_h 128 "
    "--input_w 128 --bs 24 --epochs 2 INTER --model InterNet --train_coarse",
    "--dataset synthetic --input_h 32 --input_w 64 --bs 2 --epochs 1 "
    "--disp_interval 2 --compute_dtype float32 --split val --syn_type inter "
    "--r --checkepoch 3 --checkepoch_range --torch_ckpt x.pth INTER --model "
    "InterStage3Net --stage3 --stage3_model MSResAttnRefineV2 --stage3_prop",
] + _doc_commands()


def test_doc_commands_found():
    assert len(_doc_commands()) >= 7


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_matches_jax(argv):
    ours = options.parse_args(argv.split())
    ref = joptions.parse_args(argv.split())
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert list(dataclasses.asdict(ours)) == list(dataclasses.asdict(ref))


def _actions(parser):
    rows = []
    for a in parser._actions:
        rows.append((tuple(a.option_strings), a.dest, a.default, a.type,
                     tuple(a.choices) if a.choices else None, type(a).__name__))
        if a.choices and not a.option_strings:     # the subparsers
            for name, sub in a.choices.items():
                rows += [(name,) + r for r in _actions(sub)]
    return rows


def test_parser_actions_match_jax():
    assert _actions(options.build_parser()) == _actions(joptions.build_parser())


@pytest.mark.parametrize("argv", ["", "--dataset kitti INTER",
                                  "INTER --model ExtraNet"])
def test_bad_command_lines_fail_alike(argv):
    for parse in (options.parse_args, joptions.parse_args):
        with pytest.raises(SystemExit):
            parse(argv.split())
