"""``barcoder-tpu count`` — heuristic barcode counting CLI.

Argument-compatible with the reference's ``python heuristicount.py``
(heuristicount.py:891-904): positional fasta_file, file1, optional file2.
"barcode<TAB>count" TSV on stdout, rich summary table on stderr
(heuristicount.py:754-877).
"""

from __future__ import annotations

import argparse
import os
import platform
import sys
from datetime import datetime

import rich.table
from rich.console import Console
from rich.table import Table

from ..pipeline.heuristic_count import run_count
from ..utils.logger import Logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Process Barcodes.")
    p.add_argument("fasta_file", type=str, help="List or FASTA file containing barcodes.")
    p.add_argument("file1", type=str, help="First reads file: FASTQ or raw reads.")
    p.add_argument(
        "file2", type=str, nargs="?", default=None,
        help="Second reads file: FASTQ or raw reads (optional).",
    )
    p.add_argument(
        "--engine", choices=["auto", "vector", "device", "sharded", "reference"],
        default="auto",
        help="Counting engine: vectorized host path, device-resident matcher, "
        "mesh-sharded data-parallel matcher, or per-read port.",
    )
    p.add_argument(
        "--checkpoint", default=None, metavar="PATH",
        help="Crash-safe streaming: persist partial counts to PATH and "
        "resume from it on rerun.",
    )
    return p


def summary_table(args, doc, undoc, total_reads, info) -> Table:
    cfg = info["config"]
    sample = info["sample"]
    barcodes = cfg.barcodes
    need_swap = cfg.need_swap

    if args.file2:
        file1_filename = os.path.basename(args.file1 if not need_swap else args.file2)
        file2_filename = os.path.basename(args.file2 if not need_swap else args.file1)
    else:
        file1_filename = os.path.basename(args.file1) if not need_swap else None
        file2_filename = None if not need_swap else os.path.basename(args.file1)

    t = Table(
        box=rich.table.box.SIMPLE_HEAVY,
        caption=f"Finished at [u]{datetime.now()}[/u]",
        title_style="bold bright_white",
        caption_style="white",
        header_style="bold bright_white",
        border_style="bold bright_white",
        highlight=True,
        show_header=True,
    )
    t.add_column(os.path.basename(sys.argv[0]) or "count", justify="right", style="white", min_width=30)
    t.add_column("Summary", justify="right", min_width=20)

    t.add_section()
    t.add_row("[bold bright_magenta]Input & Config[/bold bright_magenta]", "")
    t.add_row("Barcodes", f"[bold]{os.path.basename(args.fasta_file)}[/bold]")
    if file1_filename:
        t.add_row("Forward Reads", f"[bold]{file1_filename}[/bold]")
    if file2_filename:
        t.add_row("Reverse Reads", f"[bold]{file2_filename}[/bold]")
    t.add_row("Engine", f"[bold]{info['engine']}[/bold]")
    t.add_row("Operating System", f"[bold]{platform.system()}[/bold]")

    t.add_section()
    t.add_row("[bold][bright_blue]Heuristics[/bright_blue][/bold]", "")
    t.add_row("Barcode Length", f"[bold]{info['bc_len']}[/bold]")
    if sample.bc_start1:
        t.add_row("Forward Offset", f"[bold]{sample.bc_start1}[/bold]")
    if sample.bc_start2:
        t.add_row("Reverse Offset", f"[bold]{sample.bc_start2}[/bold]")
    if cfg.L_fwd or cfg.R_fwd:
        t.add_row("Forward Flanks", f"[bold]{cfg.L_fwd}...{cfg.R_fwd}[/bold]")
    if cfg.L_rev or cfg.R_rev:
        t.add_row("Reverse Flanks", f"[bold]{cfg.L_rev}...{cfg.R_rev}[/bold]")

    doc_total = sum(doc.values())
    undoc_total = sum(undoc.values())
    t.add_section()
    t.add_row("[bold]Total Reads[/bold]", f"[bold]{total_reads:,}[/bold]")
    t.add_row("Documented Barcode Reads", f"[bold]{doc_total:,}[/bold]")
    t.add_row("Undocumented Barcode Reads", f"[bold]{undoc_total:,}[/bold]")
    t.add_section()
    t.add_row("[bold]Documented Barcodes[/bold]", f"{len(barcodes):,}")
    t.add_row("Seen Documented Barcodes", f"[bold]{len(doc):,}[/bold]")
    t.add_row("Unseen Documented Barcodes", f"[bold]{len(barcodes) - len(doc):,}[/bold]")
    t.add_section()
    t.add_row("[bold]Undocumented Barcodes[/bold]", f"{len(undoc):,}")
    t.add_section()
    frac = (doc_total + undoc_total) / total_reads if total_reads else 0
    t.add_row("[bold]Barcoded Reads Fraction[/bold]", f"[bold]{frac:.3f}[/bold]")
    t.add_row(
        "Documented Fraction",
        f"[bold]{(doc_total / total_reads if total_reads else 0):.3f}[/bold]",
    )
    t.add_row(
        "Undocumented Fraction",
        f"[bold]{(undoc_total / total_reads if total_reads else 0):.3f}[/bold]",
        end_section=True,
    )

    t.add_section()
    top_doc = min(5, len(doc))
    t.add_row(f"[bold bright_green]Top {top_doc} Documented Barcodes[/bold bright_green]", "")
    for idx, (bc, count) in enumerate(doc.most_common(top_doc)):
        t.add_row(bc, f"{count:,}", end_section=idx == top_doc - 1)

    t.add_section()
    top_undoc = min(5, len(undoc))
    t.add_row(f"[bold bright_red]Top {top_undoc} Undocumented Barcodes[/bold bright_red]", "")
    for idx, (bc, count) in enumerate(undoc.most_common(top_undoc)):
        t.add_row(bc, f"{count:,}", end_section=idx == top_undoc - 1)
    return t


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log = Logger()
    log.info("Initializing heuristic barcode counting...")
    try:
        log.info("Reading barcodes...")
        log.info("Sampling reads to identify diversity characteristics...")
        doc, undoc, total_reads, info = run_count(
            args.fasta_file, args.file1, args.file2, log=log, engine=args.engine,
            checkpoint_path=args.checkpoint,
        )
        sample = info["sample"]
        log.info(
            f"Sampled {sample.new_reads_sampled:,} diverse contexts in "
            f"{sample.num_chunks} chunks and found "
            f"{len(sample.observed_barcodes):,} barcodes..."
        )
        log.info("Finishing up and collating results!")
        console = Console(stderr=True)
        console.log(summary_table(args, doc, undoc, total_reads, info))
        for barcode, count in doc.items():
            print("\t".join([barcode, str(count)]))
        return 0
    except ValueError as ve:
        log.error(str(ve))
        return 1
    except Exception as e:  # reference behavior: log, don't traceback
        # (heuristicount.py:886-888)
        log.error(f"An unexpected error occurred: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
