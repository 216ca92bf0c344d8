"""Command-line interface: vclust {deduplicate,prefilter,align,cluster,info}.

Mirrors the reference CLI surface flag-for-flag (reference vclust.py:49-598),
including the pinned UX quirks (reference test.py:41-55):

- bare ``vclust`` prints the main help to stdout, exit 0;
- a bare subcommand prints that subcommand's help to stdout, exit 0;
- argparse/validation errors -> exit 2 with ``error: ...`` on stderr;
- runtime failures -> log + exit 1;
- verbosity >= 1 logs ``Running ...`` / ``Completed`` lines per stage.

The stages run in-process on PyTorch, with the device work on CUDA (or on
the CPU with VCLUST_TORCH_DEVICE=cpu), instead of shelling out to native
binaries; the on-disk formats are identical.
"""

import argparse
import multiprocessing
import os
import pathlib
import sys

from . import __version__, ALIGN_OUTFMT
from .utils.logging import create_logger, get_logger

DEFAULT_THREAD_COUNT = min(multiprocessing.cpu_count(), 64)

COMMANDS = ('deduplicate', 'prefilter', 'align', 'cluster', 'info')


class CustomHelpFormatter(argparse.RawTextHelpFormatter):
    """Two-column help formatting comparable to the reference's."""

    def __init__(self, prog, max_help_position=32, width=100):
        super().__init__(prog, max_help_position=max_help_position,
                         width=width)

    def _format_action_invocation(self, action):
        if not action.option_strings:
            return super()._format_action_invocation(action)
        parts = ', '.join(action.option_strings)
        if action.nargs != 0:
            parts += ' ' + self._format_args(
                action, self._get_default_metavar_for_optional(action))
        return parts


def _formatter(prog):
    return CustomHelpFormatter(prog)


def input_path_type(value):
    path = pathlib.Path(value)
    if not path.exists():
        raise argparse.ArgumentTypeError(f'input does not exist: {value}')
    return path


def ranged_float_type(value):
    f = float(value)
    if f < 0 or f > 1:
        raise argparse.ArgumentTypeError('must be between 0 and 1')
    return f


def gzip_level_type(value):
    i = int(value)
    if i < 1 or i > 9:
        raise argparse.ArgumentTypeError('must be between 1 and 9')
    return i


def _add_common(parser, threads=True):
    if threads:
        parser.add_argument(
            '-t', '--threads', metavar='<int>', dest='num_threads', type=int,
            default=DEFAULT_THREAD_COUNT,
            help=f'Number of threads [{DEFAULT_THREAD_COUNT}]')
    parser.add_argument(
        '-v', metavar='<int>', dest='verbosity_level', type=int,
        choices=[0, 1, 2], default=1,
        help='Verbosity level [1]:\n0: Errors only\n1: Info\n2: Debug')
    parser.add_argument('-h', '--help', action='help',
                        help='Show this help message and exit')


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='vclust',
        description=f'vclust v{__version__}: calculate ANI and cluster '
                    'virus (meta)genome sequences (PyTorch/CUDA)',
        formatter_class=_formatter,
        add_help=False,
    )
    parser.add_argument('-v', '--version', action='version',
                        version=f'v{__version__}',
                        help="Display the tool's version and exit")
    parser.add_argument('-h', '--help', action='help',
                        help='Show this help message and exit')
    subparsers = parser.add_subparsers(dest='command', metavar='<command>')

    # --- deduplicate -------------------------------------------------------
    p = subparsers.add_parser(
        'deduplicate', formatter_class=_formatter, add_help=False,
        help='Remove duplicate genome sequences',
        description='Remove duplicate genome sequences (including reverse '
                    'complements)')
    p.add_argument('-i', '--in', metavar='<file>', nargs='+',
                   dest='input_paths', type=input_path_type, required=True,
                   help='Input FASTA file(s)')
    p.add_argument('-o', '--out', metavar='<file>', dest='output_path',
                   type=pathlib.Path, required=True,
                   help='Output FASTA file (non-redundant)')
    p.add_argument('--add-prefixes', metavar='<prefix>', nargs='*',
                   dest='add_prefixes', default=None,
                   help='Prefix sequence ids with file-specific prefixes\n'
                        '(no arguments: derive prefixes from file names)')
    p.add_argument('--gzip-output', action='store_true',
                   help='Gzip the output FASTA file')
    p.add_argument('--gzip-level', metavar='<int>', type=gzip_level_type,
                   default=4, help='Gzip compression level (1-9) [4]')
    _add_common(p)

    # --- prefilter ---------------------------------------------------------
    p = subparsers.add_parser(
        'prefilter', formatter_class=_formatter, add_help=False,
        help='Prefilter genome pairs by shared k-mer counts',
        description='Select candidate genome pairs by all-vs-all shared '
                    'k-mer counting')
    p.add_argument('-i', '--in', metavar='<file>', dest='input_path',
                   type=input_path_type, required=True,
                   help='Input FASTA file or directory of FASTA files')
    p.add_argument('-o', '--out', metavar='<file>', dest='output_path',
                   type=pathlib.Path, required=True, help='Output filter file')
    p.add_argument('-k', '--k', metavar='<int>', type=int,
                   choices=range(15, 31), default=25,
                   help='Length of k-mers (15-30) [25]')
    p.add_argument('--min-kmers', metavar='<int>', type=int, default=20,
                   help='Filter genome pairs by minimum number of shared '
                        'k-mers [20]')
    p.add_argument('--min-ident', metavar='<float>', type=ranged_float_type,
                   default=0.7,
                   help='Filter genome pairs by minimum sequence identity '
                        'of the shorter sequence (0-1) [0.7]')
    p.add_argument('--batch-size', metavar='<int>', type=int, default=0,
                   help='Process a multifasta in batches of n genomes '
                        '(0 = off) [0]')
    p.add_argument('--kmers-fraction', metavar='<float>',
                   type=ranged_float_type, default=1.0,
                   help='Fraction of k-mers to analyze per genome (0-1) [1.0]')
    p.add_argument('--max-seqs', metavar='<int>', type=int, default=0,
                   help='Max number of sequences allowed to pass the '
                        'prefilter per query (0 = unlimited) [0]')
    _add_common(p)

    # --- align -------------------------------------------------------------
    p = subparsers.add_parser(
        'align', formatter_class=_formatter, add_help=False,
        help='Align genome pairs and calculate ANI measures',
        description='Align genome pairs (LZ parse) and output ANI measures')
    p.add_argument('-i', '--in', metavar='<file>', dest='input_path',
                   type=input_path_type, required=True,
                   help='Input FASTA file or directory of FASTA files')
    p.add_argument('-o', '--out', metavar='<file>', dest='output_path',
                   type=pathlib.Path, required=True, help='Output ANI file')
    p.add_argument('--filter', metavar='<file>', dest='filter_path',
                   type=input_path_type, default=None,
                   help='Filter file from the prefilter step')
    p.add_argument('--filter-threshold', metavar='<float>',
                   type=ranged_float_type, default=0,
                   help='Align only pairs above the filter threshold [0]')
    p.add_argument('--outfmt', metavar='<str>',
                   choices=list(ALIGN_OUTFMT), default='standard',
                   help='Output format: lite, standard, complete [standard]')
    p.add_argument('--out-aln', metavar='<file>', dest='aln_path',
                   type=pathlib.Path, default=None,
                   help='Output file with alignments')
    for name, desc in [('ani', 'ANI'), ('tani', 'total ANI'),
                       ('gani', 'global ANI'), ('qcov', 'query coverage'),
                       ('rcov', 'reference coverage')]:
        p.add_argument(f'--out-{name}', metavar='<float>',
                       type=ranged_float_type, default=0,
                       help=f'Output only pairs with {desc} >= threshold [0]')
    p.add_argument('--mal', metavar='<int>', type=int, default=11,
                   help='Min. anchor length [11]')
    p.add_argument('--msl', metavar='<int>', type=int, default=7,
                   help='Min. seed length [7]')
    p.add_argument('--mrd', metavar='<int>', type=int, default=40,
                   help='Max. dist. between approx. matches in reference [40]')
    p.add_argument('--mqd', metavar='<int>', type=int, default=40,
                   help='Max. dist. between approx. matches in query [40]')
    p.add_argument('--reg', metavar='<int>', type=int, default=35,
                   help='Min. considered region length [35]')
    p.add_argument('--aw', metavar='<int>', type=int, default=15,
                   help='Approx. window length [15]')
    p.add_argument('--am', metavar='<int>', type=int, default=7,
                   help='Max. no. of mismatches in approx. window [7]')
    p.add_argument('--ar', metavar='<int>', type=int, default=3,
                   help='Min. length of run ending approx. extension [3]')
    p.add_argument('--engine', metavar='<name>', type=str, default='auto',
                   choices=['auto', 'native', 'py', 'gpu', 'tpu'],
                   help='Align engine: auto, native (exact C++, '
                        'golden-parity), py (exact Python oracle), gpu '
                        '(batched device engine on CUDA; tpu is the same '
                        'engine) [auto]')
    _add_common(p)

    # --- cluster -----------------------------------------------------------
    p = subparsers.add_parser(
        'cluster', formatter_class=_formatter, add_help=False,
        help='Cluster genomes by ANI thresholds',
        description='Cluster genome sequences based on ANI measures')
    p.add_argument('-i', '--in', metavar='<file>', dest='input_path',
                   type=input_path_type, required=True,
                   help='Input ANI file (tsv)')
    p.add_argument('-o', '--out', metavar='<file>', dest='output_path',
                   type=pathlib.Path, required=True, help='Output file')
    p.add_argument('--ids', metavar='<file>', dest='ids_path',
                   type=input_path_type, required=True,
                   help='Input file with sequence identifiers (tsv)')
    p.add_argument('-r', '--out-repr', action='store_true',
                   dest='representatives',
                   help='Output cluster representatives (longest sequence) '
                        'instead of numeric cluster ids')
    p.add_argument('--algorithm', metavar='<str>',
                   choices=['single', 'complete', 'uclust', 'cd-hit',
                            'set-cover', 'leiden'],
                   default='single',
                   help='Clustering algorithm: single, complete, uclust, '
                        'cd-hit, set-cover, leiden [single]')
    p.add_argument('--metric', metavar='<str>',
                   choices=['tani', 'gani', 'ani'], default='tani',
                   help='Similarity measure for clustering: tani, gani, '
                        'ani [tani]')
    for name in ('tani', 'gani', 'ani', 'qcov', 'rcov', 'len_ratio'):
        p.add_argument(f'--{name}', metavar='<float>',
                       type=ranged_float_type, default=0,
                       help=f'Min. {name} to cluster sequence pairs [0]')
    p.add_argument('--num_alns', metavar='<int>', type=int, default=0,
                   help='Max. number of alignments between two genomes '
                        '(0 = off) [0]')
    p.add_argument('--leiden-resolution', metavar='<float>', type=float,
                   default=0.7, help='Leiden resolution parameter [0.7]')
    p.add_argument('--leiden-beta', metavar='<float>', type=float,
                   default=0.01, help='Leiden beta parameter [0.01]')
    p.add_argument('--leiden-iterations', metavar='<int>', type=int,
                   default=2, help='Leiden number of iterations [2]')
    _add_common(p, threads=False)

    # --- info --------------------------------------------------------------
    p = subparsers.add_parser(
        'info', formatter_class=_formatter, add_help=False,
        help='Show information about the tool and its engines',
        description='Show tool/engine versions and status')
    _add_common(p, threads=False)

    return parser, subparsers


# ---------------------------------------------------------------------------
# Validators (post-parse cross-checks; errors -> parser.error, exit 2)
# ---------------------------------------------------------------------------

def validate_deduplicate(parser, args):
    if args.add_prefixes is not None and len(args.add_prefixes):
        if len(args.add_prefixes) != len(args.input_paths):
            parser.error('the number of prefixes must match the number of '
                         'input files')
    if args.add_prefixes is not None and not len(args.add_prefixes):
        args.add_prefixes = [f'{p.name.split(".")[0]}|'
                             for p in args.input_paths]
    if args.gzip_output and not str(args.output_path).endswith('.gz'):
        args.output_path = pathlib.Path(str(args.output_path) + '.gz')
    args.duplicates_path = pathlib.Path(
        str(args.output_path) + '.duplicates.txt')
    return args


def validate_fasta_input(parser, args):
    path = args.input_path
    if path.is_dir():
        from .models.input import list_fasta_dir
        files = list_fasta_dir(path)
        if len(files) < 2:
            parser.error(f'input directory must contain at least 2 FASTA '
                         f'files: {path}')
        args.is_multifasta = False
    else:
        args.is_multifasta = True
    return args


def validate_prefilter(parser, args):
    validate_fasta_input(parser, args)
    if args.batch_size and not args.is_multifasta:
        parser.error('--batch-size only supported for a single multifasta '
                     'input file')
    if args.batch_size < 0:
        parser.error('--batch-size must be non-negative')
    return args


def validate_cluster(parser, args):
    threshold = getattr(args, args.metric)
    if not threshold:
        parser.error(f'{args.metric} threshold must be above 0 '
                     f'(--{args.metric})')
    with open(args.input_path) as fh:
        header = fh.readline().rstrip('\n').split('\t')
    for required in ('qidx', 'ridx'):
        if required not in header:
            parser.error(f'missing column `{required}` in {args.input_path}')
    for name in ('tani', 'gani', 'ani', 'qcov', 'rcov', 'len_ratio',
                 'num_alns'):
        if getattr(args, name) and name not in header:
            parser.error(f'missing column `{name}` in {args.input_path}')
    if args.metric not in header:
        parser.error(f'missing column `{args.metric}` in {args.input_path}')
    args.header = header
    return args


# ---------------------------------------------------------------------------
# Handlers
# ---------------------------------------------------------------------------

def handle_deduplicate(args):
    from .models.dedup import run_deduplicate
    logger = get_logger()
    logger.info(f'Running: deduplicate {len(args.input_paths)} input '
                f'file(s) -> {args.output_path}')
    result = run_deduplicate(
        args.input_paths, args.output_path, args.duplicates_path,
        prefixes=args.add_prefixes, gzip_output=args.gzip_output,
        gzip_level=args.gzip_level)
    logger.info(f'Total sequences: {result.n_total}, unique: '
                f'{len(result.records)}')
    logger.info('Completed')


def handle_prefilter(args):
    from .models.input import load_genomes
    from .models.prefilter import run_prefilter
    from .io.formats import write_fltr
    logger = get_logger()
    logger.info(f'Running: prefilter {args.input_path} -> '
                f'{args.output_path}')
    genomes, _ = load_genomes(args.input_path)
    m = run_prefilter(
        genomes, k=args.k, min_kmers=args.min_kmers,
        min_ident=args.min_ident, kmers_fraction=args.kmers_fraction,
        max_seqs=args.max_seqs, batch_size=args.batch_size,
        num_threads=args.num_threads)
    write_fltr(args.output_path, m)
    logger.info('Completed')


def handle_align(args):
    from .models.input import load_genomes
    from .models.align import run_align
    from .ops.lz_parse_py import AlignParams
    from .io.formats import read_fltr, write_ani, write_ids, write_aln
    logger = get_logger()
    logger.info(f'Running: align {args.input_path} -> {args.output_path}')
    genomes, _ = load_genomes(args.input_path)
    filter_matrix = read_fltr(args.filter_path) if args.filter_path else None
    params = AlignParams(mal=args.mal, msl=args.msl, mrd=args.mrd,
                         mqd=args.mqd, reg=args.reg, aw=args.aw, am=args.am,
                         ar=args.ar)
    out_filters = {'ani': args.out_ani, 'tani': args.out_tani,
                   'gani': args.out_gani, 'qcov': args.out_qcov,
                   'rcov': args.out_rcov}
    result = run_align(
        genomes, params=params, filter_matrix=filter_matrix,
        filter_threshold=args.filter_threshold, out_filters=out_filters,
        keep_alignments=args.aln_path is not None,
        num_threads=args.num_threads, engine=args.engine)
    ids_path = pathlib.Path(
        str(args.output_path).rsplit('.', 1)[0] + '.ids.tsv'
        if args.output_path.suffix else str(args.output_path) + '.ids.tsv')
    write_ids(ids_path, result.objects)
    write_ani(args.output_path, result.rows, ALIGN_OUTFMT[args.outfmt])
    if args.aln_path is not None:
        write_aln(args.aln_path, result.alignments)
    logger.info('Completed')


def handle_cluster(args):
    from .io.formats import read_ani, read_ids, write_clusters
    from .models.cluster import run_cluster, ClusterParams
    logger = get_logger()
    logger.info(f'Running: cluster {args.input_path} -> {args.output_path}')
    header, rows = read_ani(args.input_path)
    objects = read_ids(args.ids_path)
    min_filters = {name: getattr(args, name)
                   for name in ('tani', 'gani', 'ani', 'qcov', 'rcov',
                                'len_ratio')}
    params = ClusterParams(
        algorithm=args.algorithm, metric=args.metric,
        metric_threshold=getattr(args, args.metric),
        min_filters=min_filters,
        max_filters={'num_alns': args.num_alns},
        out_representatives=args.representatives,
        leiden_resolution=args.leiden_resolution,
        leiden_beta=args.leiden_beta,
        leiden_iterations=args.leiden_iterations)
    labels = run_cluster(header, rows, objects, params)
    write_clusters(args.output_path, [o[0] for o in objects], labels)
    logger.info('Completed')


def handle_info(args):
    import numpy
    lines = [
        f'vclust-tpu (torch) v{__version__}',
        'engines (in-process, PyTorch/CUDA):',
    ]
    status_err = False
    try:
        import torch
        if torch.cuda.is_available():
            dev = (f'cuda: {torch.cuda.device_count()} device(s), '
                   f'{torch.cuda.get_device_name(0)}')
        else:
            dev = 'no CUDA device'
        lines.append(f'  torch      v{torch.__version__}  OK  [{dev}; '
                     f'CUDA {torch.version.cuda}]')
    except Exception as exc:   # pragma: no cover
        lines.append(f'  torch      ERROR: {exc}')
        status_err = True
    lines.append(f'  numpy      v{numpy.__version__}  OK')
    from .ops import cuda
    for name in cuda.SOURCES:
        state = 'built' if cuda.is_built(name) else 'not built'
        lines.append(f'  kernel     csrc/{name}.cu  {state}')
    from .ops import align_gpu, lz_native
    native = 'native C++' if lz_native.available() else 'Python oracle'
    lines.append(f'  align      engines: auto/native/py on the host ({native} '
                 f'for auto); gpu (= tpu): ops/align_gpu.py, pipe '
                 f'{os.environ.get("VCLUST_ALIGN_PIPE", "v3")}, v3 up to '
                 f'bucket {align_gpu.V3_MAX_BUCKET}, v2 above and for hard '
                 f'pairs')
    for mod in ('prefilter', 'align', 'cluster', 'dedup'):
        try:
            __import__(f'{__package__}.models.{mod}')
            lines.append(f'  {mod:10s} OK')
        except Exception as exc:   # pragma: no cover
            lines.append(f'  {mod:10s} ERROR: {exc}')
            status_err = True
    print('\n'.join(lines))
    if status_err:
        sys.exit(1)


HANDLERS = {
    'deduplicate': handle_deduplicate,
    'prefilter': handle_prefilter,
    'align': handle_align,
    'cluster': handle_cluster,
    'info': handle_info,
}

VALIDATORS = {
    'deduplicate': validate_deduplicate,
    'prefilter': validate_prefilter,
    'align': validate_fasta_input,
    'cluster': validate_cluster,
}


def _profiled(args, profile_dir: pathlib.Path):
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        HANDLERS[args.command](args)
    profile_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(profile_dir / f'{args.command}.trace.json'))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser, subparsers = get_parser()
    # UX quirks pinned by reference test.py:41-55.
    if not argv:
        parser.print_help(sys.stdout)
        sys.exit(0)
    if len(argv) == 1 and argv[0] in COMMANDS:
        if argv[0] == 'info':
            args = parser.parse_args(argv)
        else:
            subparsers.choices[argv[0]].print_help(sys.stdout)
            sys.exit(0)
    else:
        args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help(sys.stdout)
        sys.exit(0)
    create_logger(getattr(args, 'verbosity_level', 1))
    sub = subparsers.choices[args.command]
    validator = VALIDATORS.get(args.command)
    if validator:
        args = validator(sub, args)
    try:
        profile_dir = os.environ.get('VCLUST_PROFILE')
        if profile_dir:
            # Device-level tracing: wraps the stage in a torch.profiler
            # trace (Chrome trace JSON, viewable in Perfetto).
            _profiled(args, pathlib.Path(profile_dir))
            get_logger().info(f'Profiler trace written to {profile_dir}')
        else:
            HANDLERS[args.command](args)
    except SystemExit:
        raise
    except Exception as exc:
        get_logger().error(f'{type(exc).__name__}: {exc}')
        sys.exit(1)


if __name__ == '__main__':
    main()
