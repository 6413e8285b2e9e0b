"""Configurations of the port.  ``KITTI_MODEL_CFG`` is the flagship KITTI
pairwise-registration model (16384-point clouds with xyz + intensity, bf16
compute), a copy of the JAX package's entry-point config.
``KITTI_TRAIN_CFG`` is its training recipe, a copy of the metrics,
optimizer, scheduler and logging sections and the batch size of
``configs/training/kitti_base.yaml``: 5 pairs a micro-step, trans +
200 rot, Ranger at 5e-4 with weight decay 1e-3 and 2 accumulation steps,
and the cyclic / flat / cosine schedule.  ``MODELNET40_MODEL_CFG`` and
``MODELNET40_TRAIN_CFG`` are the same sections of
``configs/training/modelnet40.yaml``: 2048-point CAD clouds of xyz, one
MSG stage of 512 centres at radii 0.1 / 0.2, a k-30 motion embedding of
radius 0.2; 5 pairs a micro-step, trans + rot, Ranger at 5e-4 without
weight decay, 2 accumulation steps."""

KITTI_MODEL_CFG = {
    "input_dim": 4,
    "point_dim": 3,
    "label_type": "pose3d_dual_quat",
    "model_type": "deepclr",
    "params": {
        "batch_norm": False,
        "dropout": 1.0,
        "compute_dtype": "bfloat16",
        "presorted": False,
        "cloud_features": {
            "name": "SetAbstraction",
            "params": {
                "npoint": [1024],
                "radii": [[0.5, 1.0]],
                "nsamples": [[512, 1024]],
                "mlps": [[[16, 16, 32], [16, 16, 32]]],
            },
        },
        "merge": {
            "name": "MotionEmbedding",
            "params": {"k": 20, "radius": 10.0, "mlp": [128, 128, 256]},
        },
        "output": {
            "name": "OutputSimple",
            "params": {"mlp": [256, 256, 512, 512, 1024], "linear": [1024, 512, 256]},
        },
    },
}

KITTI_TRAIN_CFG = {
    "data_loader": {"batch_size": 5},
    "metrics": {
        "loss": [
            {"type": "trans", "weights": [1.0], "params": {"p": 2}},
            {"type": "rot", "weights": [200.0], "params": {"p": 2}},
        ],
        "other": [{"type": "quat_norm"}, {"type": "dual_constraint"}],
    },
    "optimizer": {
        "name": "Ranger",
        "max_iterations": 800000,
        "base_lr": 0.0005,
        "weight_decay": 0.001,
        "bias_lr_factor": 2.0,
        "weight_decay_bias": 0.0,
        "accumulation_steps": 2,
    },
    "scheduler": {
        "name": "CyclicLRWithFlatAndCosineAnnealing",
        "on_iteration": True,
        "on_validation": False,
        "needs_metrics": False,
        "params": {
            "cyclic_iterations": 600000,
            "flat_iterations": 100000,
            "annealing_iterations": 100000,
            "base_lr": 0.0000001,
            "max_lr": 0.0005,
            "step_size_up": 4000,
            "mode": "triangular",
            "cycle_momentum": False,
        },
    },
    "logging": {
        "add_graph": False,
        "summary_period": 20,
        "log_period": 200,
        "checkpoint_period": 24000,
        "checkpoint_n_saved": 10,
        "validation_period": 24000,
        "running_average_alpha": 0.001,
    },
}

MODELNET40_MODEL_CFG = {
    "input_dim": 3,
    "point_dim": 3,
    "label_type": "pose3d_dual_quat",
    "model_type": "deepclr",
    "params": {
        "batch_norm": False,
        "dropout": 1.0,
        "compute_dtype": "bfloat16",
        "cloud_features": {
            "name": "SetAbstraction",
            "params": {
                "npoint": [512],
                "radii": [[0.1, 0.2]],
                "nsamples": [[256, 512]],
                "mlps": [[[16, 16, 32], [16, 16, 32]]],
            },
        },
        "merge": {
            "name": "MotionEmbedding",
            "params": {"radius": 0.2, "k": 30, "mlp": [128, 128, 256]},
        },
        "output": {
            "name": "OutputSimple",
            "params": {"mlp": [256, 256, 512, 512, 1024], "linear": [1024, 512, 256]},
        },
    },
}

MODELNET40_TRAIN_CFG = {
    "data_loader": {"batch_size": 5},
    "metrics": {
        "loss": [
            {"type": "trans", "weights": [1.0], "params": {"p": 2}},
            {"type": "rot", "weights": [1.0], "params": {"p": 2}},
        ],
        "other": [{"type": "quat_norm"}, {"type": "dual_constraint"}],
    },
    "optimizer": {
        "name": "Ranger",
        "max_iterations": 700000,
        "base_lr": 0.0005,
        "weight_decay": 0.0,
        "bias_lr_factor": 2.0,
        "weight_decay_bias": 0.0,
        "accumulation_steps": 2,
    },
    "scheduler": {
        "name": "CyclicLRWithFlatAndCosineAnnealing",
        "on_iteration": True,
        "on_validation": False,
        "needs_metrics": False,
        "params": {
            "cyclic_iterations": 600000,
            "flat_iterations": 50000,
            "annealing_iterations": 50000,
            "base_lr": 0.00001,
            "max_lr": 0.001,
            "step_size_up": 4000,
            "mode": "triangular",
            "cycle_momentum": False,
        },
    },
    "logging": {
        "add_graph": False,
        "summary_period": 10,
        "log_period": 100,
        "checkpoint_period": 24000,
        "checkpoint_n_saved": 10,
        "validation_period": 24000,
        "running_average_alpha": 0.001,
    },
}
