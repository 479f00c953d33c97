"""The info command line: version, device, cache and model overview in a rich
console. Counterpart of the JAX package's ``info.py`` (upstream
micro_sam/util.py:1400-1558 'micro_sam_info'); its accelerator panel reports
torch, CUDA and the card."""
from __future__ import annotations

import os
import platform
import sys


def micro_sam_info(argv=None) -> None:
    """Display framework information using a rich console."""
    import argparse

    import psutil
    from rich.console import Console
    from rich.panel import Panel
    from rich.table import Table

    from . import __version__, util

    parser = argparse.ArgumentParser(description="micro_sam_tpu_torch Information Booth")
    parser.add_argument(
        "--download", nargs="+", metavar=("WHAT", "KIND"), default=None,
        help="Model download is unavailable offline; pre-seed "
        "<cachedir>/models/<name> instead (files are hash-validated on load).")
    args = parser.parse_args(argv)

    console = Console()
    console.print("[bold #0072B2]micro_sam_tpu_torch Information Booth[/bold #0072B2]",
                  justify="center")
    console.print("-" * console.width)

    console.print(Panel(
        f"[bold #F0E442]Version:[/bold #F0E442] {__version__}",
        title="micro_sam_tpu_torch Version", expand=True))
    console.print(Panel(
        "[bold #E69F00]Reference framework published in Nature Methods:[/bold #E69F00]\n"
        "https://www.nature.com/articles/s41592-024-02580-4", title="Publication"))

    cache_dir = util.microsam_cachedir()
    os.makedirs(cache_dir, exist_ok=True)
    console.print(Panel(
        f"[bold #009E73]Cache Directory:[/bold #009E73]\n{cache_dir}",
        title="Cache Directory"))

    # model zoo with local-cache status (seeded + hash-validated files)
    lines = []
    for name, entry in util.models().items():
        if name.endswith("decoder"):
            continue
        local = os.path.join(cache_dir, "models", name)
        status = "cached" if os.path.exists(local) else "not cached"
        lines.append(f"{name}  [{status}]")
    console.print(Panel(
        "[bold #D55E00]Available Models:[/bold #D55E00]\n" + "\n".join(lines),
        title="List of Supported Models"))

    # system information
    total_memory = psutil.virtual_memory().total / (1024 ** 3)
    table = Table(title="System Information", show_header=True,
                  header_style="bold #0072B2", expand=True)
    table.add_column("Property")
    table.add_column("Value", style="bold #56B4E9")
    table.add_row("System", platform.system())
    table.add_row("Node Name", platform.node())
    table.add_row("Release", platform.release())
    table.add_row("Python", sys.version.split()[0])
    table.add_row("CPU Cores", str(psutil.cpu_count()))
    table.add_row("Total Memory", f"{total_memory:.1f} GB")
    console.print(table)

    console.print(Panel(accelerator_summary(), title="Accelerator Information"))

    if args.download is not None:
        console.print(Panel(
            "Model download is not available in offline environments. "
            "Place checkpoint files at <cachedir>/models/<model_name>; they "
            "are validated against the registry xxh128 hashes on load.",
            title="Download"))


def accelerator_summary() -> str:
    """torch, its CUDA, and each card's name and memory (or that there is none)."""
    import torch

    lines = [f"[bold #000000]torch:[/bold #000000] {torch.__version__}",
             f"[bold #000000]CUDA:[/bold #000000] {torch.version.cuda}"]
    if not torch.cuda.is_available():
        return "\n".join(lines + ["[bold #000000]Devices:[/bold #000000] no CUDA device"])
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        lines.append(f"[bold #000000]Device {i}:[/bold #000000] {props.name}, "
                     f"{props.total_memory / 2**30:.1f} GiB, sm_{props.major}{props.minor}")
    return "\n".join(lines)


main = micro_sam_info


if __name__ == "__main__":
    main()
