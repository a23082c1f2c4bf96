"""LBSimulationController of the port: config parsing, geometry, launch.

Port of ``sailfish_tpu/controller.py:40-276`` with the same flags and the
same override order (rc files -> class ``update_defaults`` -> script
``default_config`` -> command line). ``--engine`` takes auto|torch|kernel
and ``--platform`` cpu|cuda (empty: CUDA; without a visible CUDA device
that raises and names ``--platform=cpu``). The
JAX-specific set-up (jax config, x64, compile cache, ``--cluster``
bootstrap) has no counterpart; ``--cluster`` raises until it is ported.
``--mode=visualization`` builds the engine of ``--vis_engine``
(``vis.engine_by_name``; 'mpl' writes PNG frames) and the runner updates
it after each output event, as ``sailfish_tpu/controller.py:255-258``.
"""

from __future__ import annotations

import sys

import numpy as np

from sailfish_tpu_torch import geo as geo_mod
from sailfish_tpu_torch import io as sio
from sailfish_tpu_torch import util
from sailfish_tpu_torch.config import LBConfigParser
from sailfish_tpu_torch.runner import SubdomainRunner


class LBSimulationController:
    """Main entry point."""

    def __init__(self, lb_class, lb_geo=None, default_config=None):
        self.lb_class = lb_class
        self._default_config = default_config or {}
        self.config_parser = LBConfigParser()
        self.dim = lb_class.subdomain.dim
        self._lb_geo = lb_geo

        group = self.config_parser.add_group('Runtime')
        group.add_argument('--mode', type=str, default='batch',
                           choices=['batch', 'benchmark', 'visualization'])
        group.add_argument('--every', type=int, default=100,
                           help='iterations between output/logging')
        group.add_argument('--from', dest='from_', type=int, default=0)
        group.add_argument('--max_iters', type=int, default=0,
                           help='number of iterations to run')
        group.add_argument('--init_iters', type=int, default=0,
                           help='consistent-initialization iterations '
                           '(not ported yet; must be 0)')
        group.add_argument('--output', type=str, default='',
                           help='output file base name')
        group.add_argument('--base_name', type=str, default='',
                           help='default base name for --log, --output '
                           'and --checkpoint_file when those are unset')
        group.add_argument('--debug_dump_dists', action='store_true',
                           default=False,
                           help='dump the raw distribution arrays at '
                           'every output event')
        group.add_argument('--debug_dump_node_type_map',
                           action='store_true', default=False,
                           help='dump the node type map at initialization')
        group.add_argument('--output_format', type=str, default='npy',
                           choices=sorted(sio.FORMATS))
        group.add_argument('--nooutput_compress', action='store_false',
                           dest='output_compress', default=True,
                           help='write uncompressed npz output')
        group.add_argument('--log', type=str, default='')
        group.add_argument('--loglevel', type=str, default='info')
        group.add_argument('--precision', type=str, default='single',
                           choices=['single', 'double', 'mixed'],
                           help='fp32 (single) or fp64 (double) '
                           'distributions, or mixed: int16 fixed-point '
                           'storage with fp32 math (single-fluid scenes; '
                           'ops/mixed.py)')
        group.add_argument('--mixed_range', type=float, default=0.5,
                           help='--precision=mixed: largest normalized '
                           'deviation |f/w - 1| the int16 codes hold '
                           '(each doubling costs one bit)')
        group.add_argument('--seed', type=int, default=0)
        group.add_argument('--grid', type=str, default='',
                           help='lattice type (D2Q9, D3Q19, ...)')
        group.add_argument('--access_pattern', type=str, default='AB',
                           choices=['AB', 'AA'],
                           help='accepted for compatibility; the port '
                           'always swaps two buffers (AB)')
        group.add_argument('--node_addressing', type=str, default='direct',
                           choices=['direct', 'indirect'])
        group.add_argument('--nouse_link_tags', action='store_false',
                           dest='use_link_tags', default=True,
                           help='orientation-vector tagging instead of '
                           'per-link tagging for link-tagged walls')
        group.add_argument('--block_size', type=int, default=128,
                           help='accepted for compatibility (CUDA block)')
        group.add_argument('--check_invalid_results_gpu',
                           action='store_true', default=False)
        group.add_argument('--check_invalid_results_host',
                           action='store_true', default=False)
        group.add_argument('--compress_intersubdomain_data',
                           action='store_true', default=False)
        group.add_argument('--profile_trace', type=str, default='',
                           help='device trace directory (not ported yet)')
        group.add_argument('--mesh', type=str, default='',
                           help='device mesh shape: N shards a '
                           'scene along z (3D) or y (2D) over N devices, '
                           "AxB along ('z', 'y') or ('y', 'x') over A x B")
        group.add_argument('--vis_engine', type=str, default='mpl',
                           help='visualization engine of '
                           '--mode=visualization (mpl: headless PNG '
                           'frames of every output event)')
        group.add_argument('--engine', type=str, default='auto',
                           choices=['auto', 'torch', 'kernel'],
                           help='step engine: kernel = the CUDA '
                           'stream-and-collide kernel, torch = plain '
                           'tensor code; auto = kernel on CUDA, torch '
                           'on the CPU')
        group.add_argument('--platform', type=str, default='',
                           choices=['', 'cpu', 'cuda'],
                           help='device to run on; empty = CUDA (the '
                           'CPU runs only when asked for)')

        group = self.config_parser.add_group('Cluster')
        group.add_argument('--cluster', action='store_true', default=False,
                           help='multi-host run (not ported yet)')
        group.add_argument('--coordinator_address', type=str, default='')
        group.add_argument('--num_processes', type=int, default=0)
        group.add_argument('--process_id', type=int, default=-1)

        group = self.config_parser.add_group('Checkpointing')
        group.add_argument('--checkpoint_file', type=str, default='')
        group.add_argument('--checkpoint_every', type=int, default=0)
        group.add_argument('--checkpoint_from', type=int, default=0)
        group.add_argument('--restore_from', type=str, default='')
        group.add_argument('--norestore_time', action='store_false',
                           dest='restore_time', default=True,
                           help='restore the distributions but restart '
                           'the iteration counter at 0')
        group.add_argument('--final_checkpoint', action='store_true',
                           default=False)
        group.add_argument('--single_checkpoint', action='store_true',
                           default=False)

        group = self.config_parser.add_group('Benchmarking')
        group.add_argument('--perf_stats_every', type=int, default=100)
        group.add_argument('--benchmark_sample_from', type=int, default=1000)
        group.add_argument('--benchmark_minibatch', type=int, default=50)

        group = self.config_parser.add_group('Geometry')
        group.add_argument('--lat_nx', type=int, default=64)
        group.add_argument('--lat_ny', type=int, default=64)
        group.add_argument('--lat_nz', type=int, default=1)
        group.add_argument('--periodic_x', action='store_true', default=False)
        group.add_argument('--periodic_y', action='store_true', default=False)
        group.add_argument('--periodic_z', action='store_true', default=False)

        lb_geo = self._geo_class()
        group = self.config_parser.add_group('Decomposition')
        lb_geo.add_options(group, self.dim)

        group = self.config_parser.add_group(
            f'{lb_class.__name__} simulation')
        for klass in reversed(lb_class.mro()):
            if hasattr(klass, 'add_options') and \
                    'add_options' in vars(klass):
                klass.add_options(group, self.dim)

    def _geo_class(self):
        if self._lb_geo is not None:
            return self._lb_geo
        return (geo_mod.LBGeometry2D if self.dim == 2
                else geo_mod.LBGeometry3D)

    def run(self, ignore_cmdline=False):
        args = [] if ignore_cmdline else sys.argv[1:]
        defaults = {}
        self.lb_class.update_defaults(defaults)
        defaults.update(self._default_config)
        config = self.config_parser.parse(args, internal_defaults=defaults)
        self.config = config
        self.lb_class.modify_config(config)
        if config.base_name:
            if not config.log:
                config.log = config.base_name + '.log'
            if not config.output:
                config.output = config.base_name
            if not config.checkpoint_file:
                config.checkpoint_file = config.base_name
        if config.cluster:
            raise NotImplementedError('--cluster is not ported yet')
        if config.seed:
            np.random.seed(config.seed)
        util.reset_logger()
        log = util.get_logger(config)
        if config.node_addressing == 'indirect':
            log.warning('node_addressing=indirect is not implemented; '
                        'running dense.')

        geo = self._geo_class()(config)
        subdomains = geo.subdomains()
        for i, s in enumerate(subdomains):
            s.id = i
        log.info('simulation: %s, domain %s, %d subdomain spec(s), '
                 'device %s',
                 self.lb_class.__name__,
                 'x'.join(str(s) for s in reversed(
                     (config.lat_ny, config.lat_nx) if self.dim == 2 else
                     (config.lat_nz, config.lat_ny, config.lat_nx))),
                 len(subdomains), config.device)

        sim = self.lb_class(config)
        output = None
        if config.output:
            output = sio.format_name_to_cls(config.output_format)(config)
        runner = SubdomainRunner(sim, geo, output=output)
        if output is not None:
            self._register_output_fields(sim, output)
        if config.mode == 'visualization':
            from sailfish_tpu_torch.vis import engine_by_name
            engine_cls = engine_by_name(config.vis_engine)
            runner.vis = engine_cls(config, lambda: sim.host_fields())
        self._runner = runner
        timing = runner.run()
        if config.mode == 'benchmark' and timing is not None:
            log.info('performance: %.2f MLUPS (sampled from iteration %d)',
                     timing.mlups, config.benchmark_sample_from)
        self.timing = timing
        return timing

    def _register_output_fields(self, sim, output):
        # register after init so arrays exist; runner re-syncs before save
        orig_init = sim.init_fields

        def patched(shape):
            orig_init(shape)
            for name, field in sim.host_fields().items():
                output.register_field(field, name,
                                      vector=isinstance(field, list))
        sim.init_fields = patched
