"""Post-processing tool set — the reference's standalone ``scripts/`` as
``deepsignal_plant_tpu_torch tools <name>`` subcommands (copy of
deepsignal_plant_tpu/tools/). Host code: none of them touches the card."""
from __future__ import annotations


def register_tools(subparsers) -> None:
    p = subparsers.add_parser(
        "tools", description="post-processing utilities (reference scripts/)")
    tool_sub = p.add_subparsers(title="tools")

    from . import ckpt, combiners, evaluate, fileops, splitters
    splitters.register(tool_sub)
    combiners.register(tool_sub)
    evaluate.register(tool_sub)
    fileops.register(tool_sub)
    ckpt.register(tool_sub)
