"""The port's engine, datasets, loaders, export, checkpoints, schemes,
networks, losses and model factory take JAX's parameters, and its
registries hold JAX's names.

``tests/test_torch_solve.py::test_port_ops_have_the_jax_signatures`` holds
every name of ``cardiax_torch.ops`` against ``cardiax.ops``; this file
extends that to the objects a caller of the engine touches: the same
parameter names, in the same order, with the same defaults, except for the
differences made by design listed in ``BY_DESIGN`` with their reasons. The
behaviour tests check what the repaired signatures return and refuse. All
run in seconds on the CPU.
"""

import importlib
import importlib.util
import inspect

import numpy as np
import pytest
import torch

import cardiax.data.datasets as jds
import cardiax.data.synthetic as jsynthetic
import cardiax.io.checkpoints as jckpt
import cardiax.io.export as jexport
import cardiax.main as jmain
import cardiax.models as jmodels
import cardiax.ops.fluid_metric as jfm
import cardiax.train.engine as jengine
import cardiax_torch.data.datasets as tds
import cardiax_torch.data.synthetic as tsynthetic
import cardiax_torch.io.checkpoints as tckpt
import cardiax_torch.io.export as texport
import cardiax_torch.main as tmain
import cardiax_torch.models as tmodels
import cardiax_torch.ops.fluid_metric as tfm
import cardiax_torch.train.engine as tengine
import cardiax.data.loader as jloader
import cardiax.data.prefetch as jprefetch
import cardiax.io.profiling as jprofiling
import cardiax.losses.calculator as jcalc
import cardiax.losses.metrics as jmetrics
import cardiax.losses.registration as jreg_losses
import cardiax.parallel.distributed as jdistributed
import cardiax.parallel.mesh as jmesh
import cardiax.train as jtrain
import cardiax_torch.data.loader as tloader
import cardiax_torch.data.prefetch as tprefetch
import cardiax_torch.io.profiling as tprofiling
import cardiax_torch.losses.calculator as tcalc
import cardiax_torch.losses.metrics as tmetrics
import cardiax_torch.losses.registration as treg_losses
import cardiax_torch.parallel.distributed as tdistributed
import cardiax_torch.parallel.mesh as tmesh
import cardiax_torch.train as ttrain
from cardiax.models.lma_net import NetDisplacement2LMA as JaxNetDisplacement2LMA
from cardiax.models.lma_net import NetStrainMat2LMA as JaxNetStrainMat2LMA
from cardiax.models.registration import RegistrationNet as JaxRegistrationNet
from cardiax.models.strain_net import \
    NetDisplacement2StrainMat as JaxNetDisplacement2StrainMat
from cardiax.train.schemes.joint_reg_regression import \
    JointRegistrationRegressionScheme as JaxJointRegressionScheme
from cardiax.train.schemes.lma import LMAScheme as JaxLMAScheme
from cardiax.train.schemes.reg import RegScheme as JaxRegScheme
from cardiax.train.schemes.strainmat_lma import \
    StrainMatLMAScheme as JaxStrainMatLMAScheme
from cardiax.train.schemes.strainmat_pred import \
    StrainMatPredScheme as JaxStrainMatPredScheme
from cardiax_torch.models.lma_net import NetDisplacement2LMA, NetStrainMat2LMA
from cardiax_torch.models.registration import RegistrationNet
from cardiax_torch.models.strain_net import NetDisplacement2StrainMat
from cardiax_torch.train.schemes.joint_reg_regression import \
    JointRegistrationRegressionScheme
from cardiax_torch.train.schemes.lma import LMAScheme
from cardiax_torch.train.schemes.reg import RegScheme
from cardiax_torch.train.schemes.strainmat_lma import StrainMatLMAScheme
from cardiax_torch.train.schemes.strainmat_pred import StrainMatPredScheme
import cardiax.config.config as jconfig
import cardiax.config.sweep as jcsweep
import cardiax.data as jdata
import cardiax.data.augmentation as jaug
import cardiax.data.datareader as jreader
import cardiax.data.split as jsplit
import cardiax.kfold as jkfold
import cardiax.native.lib as jnative
import cardiax.sweep as jsweep
import cardiax_torch.config.config as tconfig
import cardiax_torch.config.sweep as tcsweep
import cardiax_torch.data as tdata
import cardiax_torch.data.augmentation as taug
import cardiax_torch.data.datareader as treader
import cardiax_torch.data.split as tsplit
import cardiax_torch.kfold as tkfold
import cardiax_torch.native.lib as tnative
import cardiax_torch.sweep as tsweep
from cardiax.models.joint_net import \
    JointRegisterStrainMatNet as JaxJointRegisterStrainMatNet
from cardiax_torch.data.synthetic import make_dataset
from cardiax_torch.io.metrics import MetricsTracker
from cardiax_torch.models.joint_net import JointRegisterStrainMatNet
from cardiax_torch.train import build_trainer
import cardiax.plot.activation_map as jam
import cardiax.plot.colors as jcolors
import cardiax.plot.strainmat as jstrainmat
import cardiax.plot.tos_surface as jtos
import cardiax.utils as jutils
import cardiax.utils.dense as jdense
import cardiax_torch.plot.activation_map as tam
import cardiax_torch.plot.colors as tcolors
import cardiax_torch.plot.strainmat as tstrainmat
import cardiax_torch.plot.tos_surface as ttos
import cardiax_torch.utils as tutils
import cardiax_torch.utils.dense as tdense
from cardiax.train.schemes.joint_reg_strainmat_lma import \
    JointRegisterStrainmatLMAScheme as JaxJointScheme
from cardiax_torch.train.schemes.joint_reg_strainmat_lma import \
    JointRegisterStrainmatLMAScheme
from torch_budget import time_limit  # noqa: F401

# the schemes' classes, port and JAX, by name
SCHEMES = {"Scheme": (tengine.Scheme, jengine.Scheme),
           "LMAScheme": (LMAScheme, JaxLMAScheme),
           "RegScheme": (RegScheme, JaxRegScheme),
           "StrainMatPredScheme": (StrainMatPredScheme,
                                   JaxStrainMatPredScheme),
           "StrainMatLMAScheme": (StrainMatLMAScheme, JaxStrainMatLMAScheme),
           "JointRegisterStrainmatLMAScheme": (JointRegisterStrainmatLMAScheme,
                                               JaxJointScheme),
           "JointRegistrationRegressionScheme": (
               JointRegistrationRegressionScheme, JaxJointRegressionScheme)}

# the offline figures and DENSE helpers: (port module, JAX module, names)
PLOT_FUNCTIONS = (
    (tam, jam, ("stl_read", "stl_write", "extract_labeled_faces",
                "rescale_vertices_to_include", "align_vertices_with_mesh",
                "save_colored_obj", "build_3D_activation_map_single",
                "build_3D_activation_map_multiple", "plot_3D_activation_map",
                "generate_3D_activation_map")),
    (tcolors, jcolors, ("get_cmap", "map_values_to_rgb")),
    (ttos, jtos, ("text3d", "tos_3d_plot_interp")),
    (tstrainmat, jstrainmat, ("visualize_strainmat_with_TOS",
                              "visualize_pred_registration",
                              "visualize_pred_sector_classification")),
    (tutils, jutils, ("check_dict",)),
    (tdense, jdense, ("mat2dict", "loadmat", "loadStrainMat", "saveTOS2Mat",
                      "cart2pol", "pol2cart", "intersections", "spl2patchSA",
                      "face_centers", "rectfv2rectfv", "getStrainMatFull",
                      "SVDDenoise")),
)

# (port object, JAX object) by name
PAIRS = {
    "TrainerEngine.__init__": (tengine.TrainerEngine.__init__,
                               jengine.TrainerEngine.__init__),
    "TrainerEngine.train": (tengine.TrainerEngine.train,
                            jengine.TrainerEngine.train),
    "TrainerEngine.test": (tengine.TrainerEngine.test,
                           jengine.TrainerEngine.test),
    "TrainerEngine.setup": (tengine.TrainerEngine.setup,
                            jengine.TrainerEngine.setup),
    "Scheme.forward": (tengine.Scheme.forward, jengine.Scheme.forward),
    "JointDataset.__init__": (tds.JointDataset.__init__,
                              jds.JointDataset.__init__),
    "io.export.save_trained_models": (texport.save_trained_models,
                                      jexport.save_trained_models),
    "fluid_metric.solve_mm_operands": (tfm.solve_mm_operands,
                                       jfm.solve_mm_operands),
    "models.build_model": (tmodels.build_model, jmodels.build_model),
    "models.ModelBundle": (tmodels.ModelBundle.__init__,
                           jmodels.ModelBundle.__init__),
    "RegistrationNet.__init__": (RegistrationNet.__init__,
                                 JaxRegistrationNet.__init__),
    "RegistrationNet.forward": (RegistrationNet.forward,
                                JaxRegistrationNet.__call__),
    "RegScheme.__init__": (RegScheme.__init__, JaxRegScheme.__init__),
    "RegScheme.forward": (RegScheme.forward, JaxRegScheme.forward),
    "RegScheme.performance": (RegScheme.performance,
                              JaxRegScheme.performance),
    "Scheme.visualize": (tengine.Scheme.visualize, jengine.Scheme.visualize),
    "BasicRegistrationDataset.__init__": (
        tds.BasicRegistrationDataset.__init__,
        jds.BasicRegistrationDataset.__init__),
    "synthetic.make_registration_pairs": (
        tsynthetic.make_registration_pairs,
        jsynthetic.make_registration_pairs),
    "synthetic.add_displacement_fields": (
        tsynthetic.add_displacement_fields,
        jsynthetic.add_displacement_fields),
    "io.export.load_model_params": (texport.load_model_params,
                                    jexport.load_model_params),
    "main.run": (tmain.run, jmain.run),
    **{f"CheckpointManager.{m}": (getattr(tckpt.CheckpointManager, m),
                                  getattr(jckpt.CheckpointManager, m))
       for m in ("__init__", "save", "latest_epoch", "restore", "wait",
                 "close")},
    "Scheme.performance": (tengine.Scheme.performance,
                           jengine.Scheme.performance),
    "Scheme.make_loader": (tengine.Scheme.make_loader,
                           jengine.Scheme.make_loader),
    "LMAScheme.__init__": (LMAScheme.__init__, JaxLMAScheme.__init__),
    "LMAScheme.forward": (LMAScheme.forward, JaxLMAScheme.forward),
    "StrainMatPredScheme.__init__": (StrainMatPredScheme.__init__,
                                     JaxStrainMatPredScheme.__init__),
    "StrainMatPredScheme.forward": (StrainMatPredScheme.forward,
                                    JaxStrainMatPredScheme.forward),
    "StrainMatPredScheme.performance": (StrainMatPredScheme.performance,
                                        JaxStrainMatPredScheme.performance),
    "StrainMatLMAScheme.__init__": (StrainMatLMAScheme.__init__,
                                    JaxStrainMatLMAScheme.__init__),
    "StrainMatLMAScheme.forward": (StrainMatLMAScheme.forward,
                                   JaxStrainMatLMAScheme.forward),
    **{f"JointRegistrationRegressionScheme.{m}": (
        getattr(JointRegistrationRegressionScheme, m),
        getattr(JaxJointRegressionScheme, m))
       for m in ("__init__", "forward", "make_loader", "performance",
                 "_make_video")},
    **{f"{cls}.{m}": (getattr(getattr(tds, cls), m),
                      getattr(getattr(jds, cls), m))
       for cls in ("SliceGroupedDataset", "LMADataset", "StrainMatDataset")
       for m in ("__init__", "__getitem__", "get_slice", "get_n_slices",
                 "get_subject_ids", "get_slice_full_ids")},
    "datasets.build_datasets": (tds.build_datasets, jds.build_datasets),
    **{f"{cls}.{m}": (getattr(getattr(tloader, cls), m),
                      getattr(getattr(jloader, cls), m))
       for cls in ("Batcher", "SliceBatcher")
       for m in ("__init__", "set_epoch", "__iter__", "__len__")},
    **{f"DeviceBatcher.{m}": (getattr(tloader.DeviceBatcher, m),
                              getattr(jloader.DeviceBatcher, m))
       for m in ("__init__", "epoch_plan", "set_epoch", "nbytes", "__iter__",
                 "__len__")},
    **{f"PrefetchBatcher.{m}": (getattr(tprefetch.PrefetchBatcher, m),
                                getattr(jprefetch.PrefetchBatcher, m))
       for m in ("__init__", "set_epoch", "__iter__", "__len__")},
    **{f"profiling.{fn}": (getattr(tprofiling, fn), getattr(jprofiling, fn))
       for fn in ("summarize_trace", "format_summary",
                  "print_trace_summary")},
    **{f"TrainerEngine.{m}": (getattr(tengine.TrainerEngine, m),
                              getattr(jengine.TrainerEngine, m))
       for m in ("_maybe_device_cache", "_build_epoch_fns")},
    "NetStrainMat2LMA.__init__": (NetStrainMat2LMA.__init__,
                                  JaxNetStrainMat2LMA.__init__),
    "NetStrainMat2LMA.forward": (NetStrainMat2LMA.forward,
                                 JaxNetStrainMat2LMA.__call__),
    "NetDisplacement2LMA.__init__": (NetDisplacement2LMA.__init__,
                                     JaxNetDisplacement2LMA.__init__),
    "NetDisplacement2LMA.forward": (NetDisplacement2LMA.forward,
                                    JaxNetDisplacement2LMA.__call__),
    "NetDisplacement2StrainMat.__init__": (
        NetDisplacement2StrainMat.__init__,
        JaxNetDisplacement2StrainMat.__init__),
    "NetDisplacement2StrainMat.forward": (
        NetDisplacement2StrainMat.forward,
        JaxNetDisplacement2StrainMat.__call__),
    **{f"losses.{fn}": (getattr(tcalc, fn), getattr(jcalc, fn))
       for fn in ("mse_loss", "cross_entropy_loss", "get_loss_function")},
    **{f"losses.{fn}": (getattr(treg_losses, fn), getattr(jreg_losses, fn))
       for fn in ("lddmm_energy", "registration_reconstruction_loss",
                  "_sobel_magnitude", "gradient_magnitude_loss")},
    **{f"metrics.{fn}": (getattr(tmetrics, fn), getattr(jmetrics, fn))
       for fn in ("tos_sector_error", "classification_metrics",
                  "binary_auc", "threshold_sweep_f1",
                  "get_average_performance_dict")},
    "losses.HardCodedLossCalculator.__init__": (
        tcalc.HardCodedLossCalculator.__init__,
        jcalc.HardCodedLossCalculator.__init__),
    "losses.HardCodedLossCalculator.__call__": (
        tcalc.HardCodedLossCalculator.__call__,
        jcalc.HardCodedLossCalculator.__call__),
    "JointRegisterStrainMatNet._analytic_strain": (
        JointRegisterStrainMatNet._analytic_strain,
        JaxJointRegisterStrainMatNet._analytic_strain),
    "config.update_config_by_another_config": (
        tconfig.update_config_by_another_config,
        jconfig.update_config_by_another_config),
    **{f"config.sweep.{fn}": (getattr(tcsweep, fn), getattr(jcsweep, fn))
       for fn in ("load_sweep_file", "apply_sweep_params")},
    **{f"sweep.{fn}": (getattr(tsweep, fn), getattr(jsweep, fn))
       for fn in ("expand_grid", "run_sweep", "main")},
    **{f"kfold.{fn}": (getattr(tkfold, fn), getattr(jkfold, fn))
       for fn in ("run_kfold", "main")},
    "build_trainer": (ttrain.build_trainer, jtrain.build_trainer),
    **{f"parallel.mesh.{fn}": (getattr(tmesh, fn), getattr(jmesh, fn))
       for fn in ("local_device_count", "get_mesh", "batch_sharding",
                  "replicate_sharding", "shard_batch", "replicate")},
    **{f"parallel.distributed.{fn}": (getattr(tdistributed, fn),
                                      getattr(jdistributed, fn))
       for fn in ("initialize_distributed", "host_shard_bounds",
                  "shard_global_batch")},
    **{f"SplitManager.{m}": (getattr(tsplit.SplitManager, m),
                             getattr(jsplit.SplitManager, m))
       for m in ("__init__", "__len__", "__getitem__", "__iter__")},
    **{f"data.{fn}": (getattr(tdata, fn), getattr(jdata, fn))
       for fn in ("load_data", "split_vol_to_registration_pairs",
                  "get_data_from_slice")},
    **{f"augmentation.{fn}": (getattr(taug, fn), getattr(jaug, fn))
       for fn in ("translate", "rotate", "translate_ladder",
                  "rotate_sector_ladder", "rotate_by_sectors",
                  "augment_datum", "augment_all_data")},
    **{f"datareader.{fn}": (getattr(treader, fn), getattr(jreader, fn))
       for fn in ("load_DENSE_slices_from_npy_file",
                  "load_cine_pairs_from_npy_file",
                  "load_slices_from_npy_file", "try_merge_displacements",
                  "append_additional_data_from_npy", "_as_hw",
                  "_resize_slice_images", "_crop_to_myocardium",
                  "_mask_out_images")},
    **{f"datareader.{cls}.{m}": (getattr(getattr(treader, cls), m),
                                 getattr(getattr(jreader, cls), m))
       for cls, ms in (("BaseDatum", ("__init__", "feed_to_network")),
                       ("DENSEDataReader", ("load_record_from_npy",)),
                       ("BaseDataReader", ("load_record",)))
       for m in ms},
    **{f"native.{fn}": (getattr(tnative, fn), getattr(jnative, fn))
       for fn in ("load_native", "native_available", "rotate_stack",
                  "roll_stack", "collate_pad")},
    **{f"io.export.{fn}": (getattr(texport, fn), getattr(jexport, fn))
       for fn in ("save_model", "load_exported", "validate_save_method")},
    **{f"{cls}.example_model_args": (port.example_model_args,
                                     ref.example_model_args)
       for cls, (port, ref) in SCHEMES.items()},
    **{f"{tmod.__name__.split('.', 1)[1]}.{fn}": (getattr(tmod, fn),
                                                 getattr(jmod, fn))
       for tmod, jmod, fns in PLOT_FUNCTIONS for fn in fns},
}

_FLAX = {"parent", "name"}

# name -> (JAX parameters the port drops, port parameters JAX lacks, reason)
BY_DESIGN = {
    "TrainerEngine.__init__": (
        set(), {"device"},
        "the port takes mesh and keeps device: this rank's device is given "
        "at construction, None meaning the mesh's device or the card; "
        "mesh None is the one-card engine (JAX's None is every device)"),
    "TrainerEngine.setup": (
        set(), {"state_dicts"},
        "keyword-only: weights to load instead of drawing them (JAX's "
        "bundles carry their params)"),
    "Scheme.forward": (
        {"params", "train"}, set(),
        "torch modules hold their parameters and their train/eval mode"),
    "fluid_metric.solve_mm_operands": (
        set(), {"device"},
        "keyword-only: where the operands live; JAX's arrays have no "
        "device argument"),
    "models.build_model": (
        set(), {"n_pairs", "frame_size"},
        "torch modules are built with their shapes; flax infers the pair "
        "count and the frame size at the first call"),
    "models.ModelBundle": (
        {"params"}, {"initialized"},
        "the module holds its parameters; the flag says whether they were "
        "drawn or loaded yet"),
    "RegistrationNet.__init__": (
        {"channel_pack", "parent", "name"}, set(),
        "flax's module plumbing; channel_pack is a TPU layout"),
    "RegistrationNet.forward": (
        {"train"}, set(), "torch modules hold their train/eval mode"),
    "RegScheme.forward": (
        {"params", "train"}, set(),
        "torch modules hold their parameters and their train/eval mode"),
    "main.run": (
        set(), {"device"},
        "the port's entry points take the device; None means the card"),
    "sweep.run_sweep": (
        set(), {"device"},
        "the port's entry points take the device; None means the card"),
    "kfold.run_kfold": (
        set(), {"device"},
        "the port takes mesh and keeps device: the entry points take the "
        "device, None meaning the card; mesh None builds the config's "
        "mesh over this run's ranks"),
    **{f"{cls}.forward": (
        {"params", "train"}, set(),
        "torch modules hold their parameters and their train/eval mode")
       for cls in ("LMAScheme", "StrainMatPredScheme", "StrainMatLMAScheme",
                   "JointRegistrationRegressionScheme")},
    "DeviceBatcher.__init__": (
        set(), {"device"},
        "the port takes mesh and keeps device: the stacked dataset goes to "
        "the given device (default the mesh's), each rank gathers its rows"),
    "PrefetchBatcher.__init__": (
        {"mesh"}, {"device", "mesh"},
        "the port takes mesh, keyword-only, and keeps device in its place: "
        "a batch is copied to the given device, under a mesh only this "
        "rank's rows"),
    "build_trainer": (
        set(), set(),
        "the port takes mesh and keeps device: JAX ignores device, the "
        "port places the engine there (None: the mesh's device or the "
        "card)"),
    "CheckpointManager.save": (
        set(), {"texts"},
        "keyword-only: text files that the port's writer thread writes "
        "after the epoch's file, so that best_metrics.json and the file a "
        "resume reads come from one save; JAX's engine writes "
        "best_metrics.json itself while orbax's save runs"),
    "parallel.mesh.get_mesh": (
        set(), set(),
        "devices holds one device a rank, in rank order (JAX's is a list "
        "of one process's devices)"),
    "TrainerEngine._build_epoch_fns": (
        {"unroll_cap"}, set(),
        "training.epoch_fuse_max_steps caps how far JAX unrolls its scan "
        "of the step; the port replays one captured step a batch, so the "
        "key has no effect"),
    **{f"{cls}.example_model_args": (
        {"params"}, set(), "torch modules hold their parameters")
       for cls in SCHEMES},
    "NetStrainMat2LMA.__init__": (_FLAX, set(), "flax's module plumbing"),
    "NetDisplacement2LMA.__init__": (
        _FLAX, {"frame_size"},
        "flax's module plumbing; torch sizes the first dense at "
        "construction, from the frames' (H, W), which flax infers at the "
        "first call"),
    "NetDisplacement2StrainMat.__init__": (
        _FLAX | {"tmix"}, set(),
        "flax's module plumbing; tmix picks one of three TPU lowerings of "
        "one math (cardiax/models/strain_net.py:30)"),
    **{f"{cls}.forward": ({"train"}, set(),
                          "torch modules hold their train/eval mode")
       for cls in ("NetStrainMat2LMA", "NetDisplacement2LMA",
                   "NetDisplacement2StrainMat")},
}


# name -> {parameter: (port default, JAX default, reason)}
DEFAULTS_BY_DESIGN = {
    "TrainerEngine.setup": {"seed": (
        None, 2434,
        "None reads training.seed, which defaults to 2434; JAX's callers "
        "pass training.seed themselves")},
}


def _params(fn):
    return [(p.name, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_port_takes_the_jax_parameters(name):
    port, ref = PAIRS[name]
    dropped, added, _ = BY_DESIGN.get(name, (set(), set(), ""))
    defaults = DEFAULTS_BY_DESIGN.get(name, {})
    got = [p for p in _params(port) if p[0] not in added]
    want = [p for p in _params(ref) if p[0] not in dropped]
    for i, (pname, default) in enumerate(want):
        if pname in defaults:
            ours, theirs, _ = defaults[pname]
            assert default == theirs
            want[i] = (pname, ours)
    assert got == want
    names = [p[0] for p in _params(port)]
    # a name both dropped and added is one the port moves
    assert added <= set(names) and not (dropped - added) & set(names)


# JAX modules with an ``__all__`` -> the ROADMAP item that ports their names,
# for those the port does not export yet (none: ``parallel`` came last)
EXPORTS_NOT_PORTED: dict = {}


@pytest.mark.parametrize("module", ["config", "data", "io", "losses",
                                    "native", "ops", "train", "parallel"])
def test_port_exports_the_jax_names(module):
    """Every name in a JAX package module's ``__all__`` resolves in the
    port's module of the same name, or the module is listed as not ported
    yet with its ROADMAP item."""
    ref = importlib.import_module(f"cardiax.{module}")
    if module in EXPORTS_NOT_PORTED:
        assert importlib.util.find_spec(f"cardiax_torch.{module}") is None
        return
    port = importlib.import_module(f"cardiax_torch.{module}")
    missing = [n for n in ref.__all__ if not hasattr(port, n)]
    assert not missing
    assert set(ref.__all__) <= set(getattr(port, "__all__", ()))


def test_prefetch_mesh_is_keyword_only():
    param = inspect.signature(tprefetch.PrefetchBatcher.__init__).parameters[
        "mesh"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY


def test_setup_state_dicts_is_keyword_only():
    param = inspect.signature(tengine.TrainerEngine.setup).parameters[
        "state_dicts"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY


def test_setup_takes_the_jax_call():
    """JAX's own call, ``trainer.setup(networks, example, steps_per_epoch=1,
    seed=...)`` (``cardiax/main.py``), on configs/reg.json's networks: the
    batch lands on ``example_batch`` and is not read; the weights are drawn
    from the seed, so two engines set up alike hold equal weights and one
    optimizer per configured model."""
    import json
    from pathlib import Path
    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs"
                      / "reg.json").read_text())
    pairs = tsynthetic.make_registration_pairs(make_dataset(
        n_subjects=1, slices_per_subject=1, h=16, w=16, n_frames=3,
        seed=3))
    ds = tds.BasicRegistrationDataset(
        pairs, dataset_config=cfg["datasets"]["train"])
    states = []
    for _ in range(2):
        eng = build_trainer(cfg["training"], "cpu", cfg)
        example = next(iter(eng.scheme.make_loader(ds, 2, shuffle=False)))
        networks = {n: tmodels.build_model(mc)
                    for n, mc in cfg["networks"].items()}
        eng.setup(networks, example, steps_per_epoch=1, seed=2434)
        assert set(eng.modules) == set(cfg["networks"])
        assert set(eng.optimizers) == set(cfg["training"]["optimizers"])
        states.append({k: v.clone() for k, v in
                       eng.modules["registration"].state_dict().items()})
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k


def test_solve_mm_operands_device_is_keyword_only():
    param = inspect.signature(tfm.solve_mm_operands).parameters["device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY


def test_solve_mm_operands_refuses_lane_packing():
    for pr, pc in ((2, 1), (1, 2)):
        with pytest.raises(ValueError, match="lane-packed"):
            tfm.solve_mm_operands(8, 8, pr, pc)


def test_solve_mm_operands_positional_metric():
    """A positional ``pr`` no longer lands on ``alpha``: the metric comes
    after ``pr, pc``, as in JAX."""
    port = tfm.solve_mm_operands(8, 6, 1, 1, 0.5, 1.0, 2)
    ref = jfm.solve_mm_operands(8, 6, 1, 1, 0.5, 1.0, 2)
    for out, want in zip(port, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-7,
                                   rtol=0)


T_MYO = 4


def _data_cfg():
    return {"n_myo_frames_to_use_for_regression": T_MYO,
            "n_strainmat_frames_to_use_for_regression": 8}


def test_joint_dataset_takes_augmentation_first():
    """``augmentation`` comes second, as in JAX, and like JAX's the three
    datasets that take it never read it: any value gives the same items."""
    data = make_dataset(n_subjects=2, slices_per_subject=1, h=8, w=8,
                        n_frames=6, seed=1)
    by_position = tds.JointDataset(data, None, _data_cfg())
    by_name = tds.JointDataset(data, dataset_config=_data_cfg())
    assert len(by_position) == len(by_name) == 2
    for i in range(2):
        a, b = by_position[i], by_name[i]
        assert a.keys() == b.keys()
        assert a["cine_myo_mask"].shape == (1, T_MYO, 8, 8)
        for k in ("cine_myo_mask", "strain_matrix", "TOS"):
            np.testing.assert_array_equal(a[k], b[k])
    disp = tsynthetic.add_displacement_fields(
        make_dataset(n_subjects=2, slices_per_subject=1, h=8, w=8,
                     n_frames=6, seed=2), seed=2)
    lma_cfg = {"n_frames_to_use_for_regression": 6}
    for cls, items, cfg in ((tds.JointDataset, data, _data_cfg()),
                            (tds.LMADataset, disp, lma_cfg),
                            (tds.StrainMatDataset, disp, lma_cfg)):
        plain = cls(items, None, cfg)
        jax_plain = getattr(jds, cls.__name__)(items, None, cfg)
        for aug in ({"rotate": 1}, "anything", 3):
            port = cls(items, aug, cfg)
            assert len(port) == len(plain) == len(jax_plain)
            jax_aug = getattr(jds, cls.__name__)(items, aug, cfg)
            for i in range(len(port)):
                for k, v in plain[i].items():
                    if isinstance(v, np.ndarray):
                        np.testing.assert_array_equal(port[i][k], v)
                        np.testing.assert_array_equal(jax_aug[i][k],
                                                      jax_plain[i][k])


def _tiny_engine():
    """The flagship scheme at 16^2, 4 features, on the CPU."""
    sched = {"enable": True, "type": "CosineAnnealingLR", "T_max": 30,
             "eta_min": 1e-5}
    opt = {"type": "Adam", "weight_decay": 1e-4, "learning_rate": 1e-3,
           "lr_scheduler": sched}
    cfg = {
        "networks": {
            "joint_register_strainmat": {
                "type": "JointRegisterStrainMatNet",
                "strainmat_net_type": "ResNet3D",
                "n_strain_matrix_frames": 8,
                "strainmat_smoothing_method": "SVD",
                "strainmat_smoothing_SVD_rank": 5, "n_integration_steps": 2,
                "alpha": 2.0, "gamma": 1.0, "reg_features": 4,
                "reg_half_res": False},
            "LMA": {"type": "NetStrainMat2LMA", "LMA_task": "TOS_regression",
                    "num_conv_layers": 3, "inner_conv_channel_num": 4,
                    "n_frames": 8, "n_sectors": 126},
        },
        "training": {"scheme": "joint_registration_strainmat_LMA",
                     "batch_size": 2, "LMA_threshold": 20, "seed": 7,
                     "epochs": 1,
                     "optimizers": {"joint_register_strainmat": dict(opt),
                                    "LMA": dict(opt)}},
        "losses": {
            "registration_reconstruction": {
                "criterion": "registration_reconstruction",
                "prediction": "various", "target": "registration_target",
                "weight": 1.0, "sigma": 0.03, "regularization_weight": 0.1,
                "enable": True},
            "TOS_regression": {
                "criterion": "MSELoss", "prediction": "TOS", "target": "TOS",
                "weight": 0.005, "enable": True}},
    }
    data = make_dataset(n_subjects=3, slices_per_subject=1, h=16, w=16,
                        n_frames=T_MYO, seed=8)
    datasets = {"test": tds.JointDataset(data, dataset_config=_data_cfg())}
    nets = {n: tmodels.build_model(mc, n_pairs=T_MYO - 1)
            for n, mc in cfg["networks"].items()}
    return build_trainer(cfg["training"], "cpu", cfg), nets, datasets, cfg


def test_engine_test_returns_the_tracker_third():
    eng, nets, datasets, cfg = _tiny_engine()
    tracker = MetricsTracker(quiet=True)
    preds, perf, got = eng.test(nets, datasets, cfg["training"], cfg, "cpu",
                                None, "test", tracker)
    assert got is tracker
    assert len(preds) == 3 and np.isfinite(perf["final-test/sector_error"])
    assert eng.test(nets, datasets)[2] is None


def test_engine_refuses_another_device():
    eng, nets, datasets, cfg = _tiny_engine()
    other = torch.device("meta")
    with pytest.raises(ValueError, match="engine runs on cpu"):
        eng.train(nets, {"train": datasets["test"]}, cfg["training"], cfg,
                  other)
    with pytest.raises(ValueError, match="engine runs on cpu"):
        eng.test(nets, datasets, cfg["training"], cfg, other)


def _registries():
    """(port registry, JAX registry, port lookup of one name)."""
    return {
        "schemes": (ttrain._SCHEME_REGISTRY, jtrain._SCHEME_REGISTRY,
                    lambda n: ttrain.build_trainer({"scheme": n}, "cpu", {})),
        "models": (tmodels._MODEL_REGISTRY, jmodels._MODEL_REGISTRY,
                   lambda n: tmodels.build_model({"type": n})),
        "criteria": (tcalc._CRITERIA, jcalc._CRITERIA,
                     tcalc.get_loss_function),
        "datasets": (tds._DATASET_REGISTRY, jds._DATASET_REGISTRY,
                     lambda n: tds.build_datasets({"x": {"type": n}}, {})),
    }


@pytest.mark.parametrize("registry", ["schemes", "models", "criteria",
                                      "datasets"])
def test_registries_hold_the_jax_names(registry):
    """JAX's six schemes, seven model type names, four criteria and four
    datasets; an unknown name raises ``KeyError`` naming the known ones,
    as in JAX."""
    port, ref, lookup = _registries()[registry]
    assert set(port) == set(ref)
    with pytest.raises(KeyError, match="known: .*" + sorted(ref)[0]):
        lookup("nope")
