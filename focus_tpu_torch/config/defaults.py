"""Default configuration tree.

Key-for-key the same surface as the reference framework's config
(reference: ``slowfast/config/defaults.py:12-1214``) so that every YAML
under ``configs/`` runs unchanged.  The tree is declared as one nested
literal and materialised into :class:`~focus_tpu_torch.config.node.CfgNode`.

TPU-specific additions live under the ``TPU`` node (mesh shape, dtype
policy) — new keys only, never repurposed reference keys.
"""

from focus_tpu_torch.config.node import CfgNode

from . import custom_config

_DEFAULTS = {
    # ----- STEVE-in-backbone options (reference defaults.py:18-31) -----
    "STEVE": {
        "INIT_WEIGHTS": False,
        "O": 5,
        "ENABLE": False,
        "LAYERS": [],
        "ADD_LAYERS": [],
        "USE_MOTION_STREAM": True,
        "MOTION_STREAM_ATTN_TYPE": "joint",
    },
    # ----- experiment bookkeeping (:35-37) -----
    "EXP": {"NAME": "test", "PATH": ""},
    # ----- slot-attention / STEVE model options (:41-69) -----
    "SLOTS": {
        "SIZE": 192,
        "DIM": 192,
        "NUM_SLOTS": 7,
        "HEADS": 1,
        "HARD": True,
        "NUM_ITERS": 3,
        "IMG_CHANNELS": 3,
        "IMG_SIZE": 64,
        "USE_SSL_FEAT": False,
        "USE_PIXEL_RECON": False,
        "SSL_TYPE": "dino",
        "TEACHER": "r50",
        "ARCH": "steve",
        "CNN_HID_SIZE": 64,
        "MLP_HID_SIZE": 1024,
        "NUM_PREDICTOR_HEADS": 8,
        "NUM_PREDICTOR_BLOCKS": 4,
        "PREDICTOR_DROPOUT": 0.0,
        "VOCAB_SIZE": 4096,
        "OUT_H": 8,
        "OUT_W": 14,
        "DECODER": {
            "TYPE": "mlp",
            "NUM_BLOCKS": 8,
            "NUM_HEADS": 4,
            "DIM": 2048,
            "DROPOUT": 0.1,
        },
    },
    # ----- ORViT options (:76-97) -----
    "ORVIT": {
        "INIT_WEIGHTS": False,
        "ZERO_INIT_ORVIT": False,
        "LOAD_ORVIT_ATTN_LAYERS_FROM_BB": True,
        "O": 5,
        "ENABLE": False,
        "LAYERS": [],
        "ADD_LAYERS": [],
        "USE_MOTION_STREAM": True,
        "MOTION_STREAM_ATTN_TYPE": "joint",
        "MOTION_STREAM_DIM": -1,
        "MOTION_STREAM_N_HEADS": 12,
        "MOTION_STREAM_SEP_POS_EMB": False,
        "FIXED_TRAJ": False,
    },
    # ----- batch-norm options (:102-122) -----
    "BN": {
        "USE_PRECISE_STATS": False,
        "NUM_BATCHES_PRECISE": 200,
        "WEIGHT_DECAY": 0.0,
        "NORM_TYPE": "batchnorm",
        "NUM_SPLITS": 1,
        "NUM_SYNC_DEVICES": 1,
    },
    # ----- training options (:128-185) -----
    "TRAIN": {
        "ENABLE": True,
        "METHOD": "slots",
        "DATASET": "kinetics",
        "BATCH_SIZE": 64,
        "NUM_WORKERS": 4,
        "EVAL_PERIOD": 10,
        "CHECKPOINT_PERIOD": 10,
        "AUTO_RESUME": True,
        "CHECKPOINT_FILE_PATH": "",
        "CHECKPOINT_TYPE": "pytorch",
        "CHECKPOINT_INFLATE": False,
        "CHECKPOINT_EPOCH_RESET": False,
        "CHECKPOINT_CLEAR_NAME_PATTERN": (),
        "CHECKPOINT_REPLACE_NAME_PATTERN": [],
        "MIXED_PRECISION": False,
        "VAL_ONLY": False,
        "LOG_PATH": "",
        "LOG_INTERVAL": 2000,
        "CHECKPOINT_PATH": "",
    },
    # ----- augmentation options (:190-222) -----
    "AUG": {
        "ENABLE": False,
        "NUM_SAMPLE": 1,
        "COLOR_JITTER": 0.4,
        "AA_TYPE": "rand-m9-mstd0.5-inc1",
        "DIFFERENT_AUG_PER_FRAME": False,
        "INTERPOLATION": "bicubic",
        "RE_PROB": 0.25,
        "RE_MODE": "pixel",
        "RE_COUNT": 1,
        "RE_SPLIT": False,
    },
    # ----- mixup options (:227-245) -----
    "MIXUP": {
        "ENABLE": False,
        "ALPHA": 0.8,
        "CUTMIX_ALPHA": 1.0,
        "PROB": 1.0,
        "SWITCH_PROB": 0.5,
        "LABEL_SMOOTH_VALUE": 0.1,
    },
    # ----- testing options (:250-279) -----
    "TEST": {
        "ENABLE": True,
        "DATASET": "kinetics",
        "EVAL_TASK": "segmentation",
        "BATCH_SIZE": 8,
        "CHECKPOINT_FILE_PATH": "",
        "NUM_ENSEMBLE_VIEWS": 10,
        "NUM_SPATIAL_CROPS": 3,
        "CHECKPOINT_TYPE": "pytorch",
        "SAVE_RESULTS_PATH": "",
        "TEST_EPOCH_NUM": -1,
    },
    # ----- ResNet options (:284-315) -----
    "RESNET": {
        "TRANS_FUNC": "bottleneck_transform",
        "NUM_GROUPS": 1,
        "WIDTH_PER_GROUP": 64,
        "INPLACE_RELU": True,
        "STRIDE_1X1": False,
        "ZERO_INIT_FINAL_BN": False,
        "DEPTH": 50,
        "NUM_BLOCK_TEMP_KERNEL": [[3], [4], [6], [3]],
        "SPATIAL_STRIDES": [[1], [2], [2], [2]],
        "SPATIAL_DILATIONS": [[1], [1], [1], [1]],
    },
    # ----- X3D options (:321-346) -----
    "X3D": {
        "WIDTH_FACTOR": 1.0,
        "DEPTH_FACTOR": 1.0,
        "BOTTLENECK_FACTOR": 1.0,
        "DIM_C5": 2048,
        "DIM_C1": 12,
        "SCALE_RES2": False,
        "BN_LIN5": False,
        "CHANNELWISE_3x3x3": True,
    },
    # ----- non-local options (:351-373) -----
    "NONLOCAL": {
        "LOCATION": [[[]], [[]], [[]], [[]]],
        "GROUP": [[1], [1], [1], [1]],
        "INSTANTIATION": "dot_product",
        "POOL": [
            [[1, 2, 2], [1, 2, 2]],
            [[1, 2, 2], [1, 2, 2]],
            [[1, 2, 2], [1, 2, 2]],
            [[1, 2, 2], [1, 2, 2]],
        ],
    },
    # ----- model options (:378-413) -----
    "MODEL": {
        "ARCH": "slowfast",
        "MODEL_NAME": "SlowFast",
        "CNN_NAME": "base",
        "NUM_CLASSES": 400,
        "LOSS_FUNC": "cross_entropy",
        "SINGLE_PATHWAY_ARCH": ["2d", "c2d", "i3d", "slow", "x3d", "mvit"],
        "MULTI_PATHWAY_ARCH": ["slowfast"],
        "DROPOUT_RATE": 0.5,
        "DROPCONNECT_RATE": 0.0,
        "FC_INIT_STD": 0.01,
        "HEAD_ACT": "softmax",
        "LOAD_IN_PRETRAIN": "",
    },
    # ----- MViT options (:418-499) -----
    "MVIT": {
        "MODE": "conv",
        "POOL_FIRST": False,
        "CLS_EMBED_ON": True,
        "PATCH_KERNEL": [3, 7, 7],
        "PATCH_STRIDE": [2, 4, 4],
        "PATCH_PADDING": [2, 4, 4],
        "PATCH_2D": False,
        "EMBED_DIM": 96,
        "NUM_HEADS": 1,
        "MLP_RATIO": 4.0,
        "QKV_BIAS": True,
        "DROPPATH_RATE": 0.1,
        "DEPTH": 16,
        "NORM": "layernorm",
        "DIM_MUL": [],
        "HEAD_MUL": [],
        "POOL_KV_STRIDE": None,
        "POOL_KV_STRIDE_ADAPTIVE": None,
        "POOL_Q_STRIDE": [],
        "POOL_KVQ_KERNEL": None,
        "ZERO_DECAY_POS_CLS": True,
        "NORM_STEM": False,
        "SEP_POS_EMBED": False,
        "DROPOUT_RATE": 0.0,
        "POOL_KV_IGNORE_111_KERNEL": False,
    },
    # ----- Motionformer options (:504-573) -----
    "MF": {
        "PATCH_SIZE": 16,
        "PATCH_SIZE_TEMP": 2,
        "CHANNELS": 3,
        "EMBED_DIM": 768,
        "DEPTH": 12,
        "NUM_HEADS": 12,
        "MLP_RATIO": 4,
        "QKV_BIAS": True,
        "VIDEO_INPUT": True,
        "TEMPORAL_RESOLUTION": 8,
        "USE_MLP": False,
        "DROP": 0.0,
        "DROP_PATH": 0.0,
        "HEAD_DROPOUT": 0.0,
        "POS_DROPOUT": 0.0,
        "ATTN_DROPOUT": 0.0,
        "HEAD_ACT": "tanh",
        "IM_PRETRAINED": True,
        "PRETRAINED_WEIGHTS": "vit_1k",
        "POS_EMBED": "separate",
        "ATTN_LAYER": "trajectory",
        "APPROX_ATTN_TYPE": "none",
        "APPROX_ATTN_DIM": 128,
    },
    # ----- SlowFast options (:578-593) -----
    "SLOWFAST": {
        "BETA_INV": 8,
        "ALPHA": 8,
        "FUSION_CONV_CHANNEL_RATIO": 2,
        "FUSION_KERNEL_SZ": 5,
    },
    # ----- data options (:599-699) -----
    "DATA": {
        "PATH_TO_DATA_DIR": "",
        "PATH_LABEL_SEPARATOR": " ",
        "PATH_PREFIX": "",
        "NUM_FRAMES": 8,
        "SAMPLING_RATE": 8,
        "TRAIN_PCA_EIGVAL": [0.225, 0.224, 0.229],
        "TRAIN_PCA_EIGVEC": [
            [-0.5675, 0.7192, 0.4009],
            [-0.5808, -0.0045, -0.8140],
            [-0.5836, -0.6948, 0.4203],
        ],
        "PATH_TO_PRELOAD_IMDB": "",
        "MEAN": [0.45, 0.45, 0.45],
        "INPUT_CHANNEL_NUM": [3, 3],
        "STD": [0.225, 0.225, 0.225],
        "TRAIN_JITTER_SCALES": [256, 320],
        "TRAIN_JITTER_SCALES_RELATIVE": [],
        "TRAIN_JITTER_ASPECT_RELATIVE": [],
        "USE_OFFSET_SAMPLING": False,
        "TRAIN_JITTER_MOTION_SHIFT": False,
        "TRAIN_CROP_SIZE": 224,
        "TEST_CROP_SIZE": 256,
        "TARGET_FPS": 30,
        "DECODING_BACKEND": "pyav",
        "INV_UNIFORM_SAMPLE": False,
        "RANDOM_FLIP": True,
        "MULTI_LABEL": False,
        "ENSEMBLE_METHOD": "sum",
        "REVERSE_INPUT_CHANNEL": False,
        "GLOB_EXP": "*.png",
        "NUM_SEGS": 25,
        "SPLIT": "ctp",
        "FOLD": 1,
        "SCALE": [448, 256, 448, 256],
        "FEAT_H": 8,
        "FEAT_W": 14,
        "PATH": "",
    },
    # ----- Cholec80 options (:701-705) -----
    "CHOLEC": {
        "PATH": "datasets/cholec80/labels",
        "TRAIN_PKL": "1fps_100_0.pickle",
        "VAL_PKL": "1fps.pickle",
        "TEST_PKL": "1fps.pickle",
    },
    # ----- slot optimizer options (:710-721) -----
    "SLOTS_OPTIM": {
        "DVAE": 3e-4,
        "ENC": 1e-4,
        "DEC": 4e-4,
        "HALF_LIFE": 100000,
        "WARMUP_STEPS": 20000,
        "CLIP": 1.0,
        "TAU_START": 1.0,
        "TAU_FINAL": 0.1,
        "TAU_STEPS": 30000,
        "STEPS": 200000,
        "STEP_INTERVAL": 5000,
    },
    # ----- solver options (:726-792) -----
    "SOLVER": {
        "BASE_LR": 0.1,
        "ORVIT_BASE_LR": -1.0,
        "LR_POLICY": "cosine",
        "COSINE_END_LR": 0.0,
        "GAMMA": 0.1,
        "STEP_SIZE": 1,
        "STEPS": [],
        "LRS": [],
        "MAX_EPOCH": 300,
        "MOMENTUM": 0.9,
        "DAMPENING": 0.0,
        "NESTEROV": True,
        "WEIGHT_DECAY": 1e-4,
        "WARMUP_FACTOR": 0.1,
        "WARMUP_EPOCHS": 0.0,
        "WARMUP_START_LR": 0.01,
        "OPTIMIZING_METHOD": "sgd",
        "BASE_LR_SCALE_NUM_SHARDS": False,
        "COSINE_AFTER_WARMUP": False,
        "ZERO_WD_1D_PARAM": False,
        "CLIP_GRAD_VAL": None,
        "CLIP_GRAD_L2NORM": 0.05,
    },
    # ----- global options (:798-824) -----
    "NUM_GPUS": 1,
    "CUDA_VISIBLE_DEVICES": "0",
    "NUM_SHARDS": 1,
    "SHARD_ID": 0,
    "OUTPUT_DIR": "./tmp",
    "RNG_SEED": 1,
    "LOG_PERIOD": 10,
    "LOG_MODEL_INFO": False,
    "DIST_BACKEND": "nccl",
    "SPLIT_QKV_CHECKPOINT": False,
    # ----- benchmark options (:829-838) -----
    "BENCHMARK": {"NUM_EPOCHS": 5, "LOG_PERIOD": 100, "SHUFFLE": True},
    # ----- data-loader options (:844-853) -----
    "DATA_LOADER": {
        "NUM_WORKERS": 8,
        "PIN_MEMORY": True,
        "ENABLE_MULTI_THREAD_DECODE": False,
        # worker pool kind (TPU extension): "thread" (default — decode
        # and cv2/numpy transforms release the GIL, so threads scale
        # with zero IPC cost) or "process" (spawn-context pool; sidesteps
        # the GIL entirely for Python-heavy __getitem__ paths on
        # many-core hosts at the cost of pickling the dataset once per
        # worker and samples back per item).
        "WORKER_BACKEND": "thread",
    },
    # ----- detection options (:859-871) -----
    "DETECTION": {
        "ENABLE": False,
        "ALIGNED": True,
        "SPATIAL_SCALE_FACTOR": 16,
        "ROI_XFORM_RESOLUTION": 7,
    },
    # ----- SSv2 options (:877-885) -----
    "SSV2": {
        "DATA_ROOT": "",
        "SPLITS_ROOT": "",
        "SPLIT": "standard",
        "BOXES_FORMAT": "detectron2",
    },
    # ----- EPIC-KITCHENS options (:891-912) -----
    "EPICKITCHENS": {
        "VISUAL_DATA_DIR": "",
        "ANNOTATIONS_DIR": "",
        "TRAIN_LIST": "EPIC_100_train.pkl",
        "VAL_LIST": "EPIC_100_validation.pkl",
        "TEST_LIST": "EPIC_100_validation.pkl",
        "TEST_SPLIT": "validation",
        "TRAIN_PLUS_VAL": False,
    },
    # ----- AVA options (:917-980) -----
    "AVA": {
        "FRAME_DIR": "",
        "FRAME_LIST_DIR": "",
        "ANNOTATION_DIR": "",
        "TRAIN_LISTS": ["train.csv"],
        "TEST_LISTS": ["val.csv"],
        "TRAIN_GT_BOX_LISTS": ["ava_train_v2.2.csv"],
        "TRAIN_PREDICT_BOX_LISTS": [],
        "TEST_PREDICT_BOX_LISTS": ["ava_val_predicted_boxes.csv"],
        "DETECTION_SCORE_THRESH": 0.9,
        "BGR": False,
        "TRAIN_USE_COLOR_AUGMENTATION": False,
        "TRAIN_PCA_JITTER_ONLY": True,
        "TEST_FORCE_FLIP": False,
        "FULL_TEST_ON_VAL": False,
        "LABEL_MAP_FILE": "ava_action_list_v2.2_for_activitynet_2019.pbtxt",
        "EXCLUSION_FILE": "ava_val_excluded_timestamps_v2.2.csv",
        "GROUNDTRUTH_FILE": "ava_val_v2.2.csv",
        "IMG_PROC_BACKEND": "cv2",
        "CENTER_CROP_TEST": True,
    },
    # ----- multigrid options (:985-1022) -----
    "MULTIGRID": {
        "EPOCH_FACTOR": 1.5,
        "SHORT_CYCLE": False,
        "SHORT_CYCLE_FACTORS": [0.5, 0.5 ** 0.5],
        "LONG_CYCLE": False,
        "LONG_CYCLE_FACTORS": [
            (0.25, 0.5 ** 0.5),
            (0.5, 0.5 ** 0.5),
            (0.5, 1),
            (1, 1),
        ],
        "BN_BASE_SIZE": 8,
        "EVAL_FREQ": 3,
        "LONG_CYCLE_SAMPLING_RATE": 0,
        "DEFAULT_B": 0,
        "DEFAULT_T": 0,
        "DEFAULT_S": 0,
    },
    # ----- tensorboard options (:1027-1122) -----
    "TENSORBOARD": {
        "ENABLE": True,
        "PREDICTIONS_PATH": "",
        "LOG_DIR": "",
        "CLASS_NAMES_PATH": "",
        "CATEGORIES_PATH": "",
        "CONFUSION_MATRIX": {"ENABLE": False, "FIGSIZE": [8, 8], "SUBSET_PATH": ""},
        "HISTOGRAM": {
            "ENABLE": False,
            "SUBSET_PATH": "",
            "TOPK": 10,
            "FIGSIZE": [8, 8],
        },
        "MODEL_VIS": {
            "ENABLE": False,
            "MODEL_WEIGHTS": False,
            "ACTIVATIONS": False,
            "INPUT_VIDEO": False,
            "LAYER_LIST": [],
            "TOPK_PREDS": 1,
            "COLORMAP": "Pastel2",
            "GRAD_CAM": {
                "ENABLE": True,
                "LAYER_LIST": [],
                "USE_TRUE_LABEL": False,
                "COLORMAP": "viridis",
            },
        },
        "WRONG_PRED_VIS": {
            "ENABLE": False,
            "TAG": "Incorrectly classified videos.",
            "SUBSET_PATH": "",
        },
    },
    # ----- demo options (:1128-1211) -----
    "DEMO": {
        "ENABLE": False,
        "LABEL_FILE_PATH": "",
        "WEBCAM": -1,
        "INPUT_VIDEO": "",
        "DISPLAY_WIDTH": 0,
        "DISPLAY_HEIGHT": 0,
        "DETECTRON2_CFG": "COCO-Detection/faster_rcnn_R_50_FPN_3x.yaml",
        "DETECTRON2_WEIGHTS": "",
        "DETECTRON2_THRESH": 0.9,
        "BUFFER_SIZE": 0,
        "OUTPUT_FILE": "",
        "OUTPUT_FPS": -1,
        "INPUT_FORMAT": "BGR",
        "CLIP_VIS_SIZE": 10,
        "NUM_VIS_INSTANCES": 2,
        "PREDS_BOXES": "",
        "THREAD_ENABLE": False,
        "NUM_CLIPS_SKIP": 0,
        "GT_BOXES": "",
        "STARTING_SECOND": 900,
        "FPS": 30,
        "VIS_MODE": "thres",
        "COMMON_CLASS_THRES": 0.7,
        "UNCOMMON_CLASS_THRES": 0.3,
        "COMMON_CLASS_NAMES": [
            "watch (a person)",
            "talk to (e.g., self, a person, a group)",
            "listen to (a person)",
            "touch (an object)",
            "carry/hold (an object)",
            "walk",
            "sit",
            "lie/sleep",
            "bend/bow (at the waist)",
        ],
        "SLOWMO": 1,
    },
    # ----- TPU-native extensions (new keys, no reference equivalent) -----
    "TPU": {
        # dtype for activations under jit ("bfloat16" or "float32").
        "COMPUTE_DTYPE": "bfloat16",
        # mesh axis sizes; -1 on DATA means "all devices". SEQ > 1
        # shards the token axis of transformer activations (sequence
        # parallelism — LN/MLP/projections run token-sharded; GSPMD
        # gathers k/v where attention needs the full sequence).
        # PIPE > 1 pipeline-parallelises a homogeneous transformer stack
        # (GPipe-style circular pipeline over the 'pipe' mesh axis;
        # requires MF depth % PIPE == 0 and no ORViT interleave).
        # PIPE_MICROBATCHES: microbatches per step (0 -> PIPE); bubble
        # fraction is (PIPE-1)/(M+PIPE-1).
        "MESH": {"DATA": -1, "MODEL": 1, "SEQ": 1, "PIPE": 1,
                 "PIPE_MICROBATCHES": 0, "EXPERT": 1},
        # Mixture-of-Experts block MLPs (models/moe.py): NUM_EXPERTS > 1
        # replaces the transformer MLPs with Switch-style top-1-routed
        # expert FFNs; MESH.EXPERT shards the expert dim (expert
        # parallelism). A TPU scaling extension beyond the reference.
        "MOE": {"NUM_EXPERTS": 0, "CAPACITY_FACTOR": 1.25,
                "AUX_LOSS_WEIGHT": 0.01},
        # number of device-prefetch buffers for the input pipeline.
        "PREFETCH": 2,
        # output path for tools/export_model.py (serialized jax.export
        # StableHLO artifact of the eval step, weights baked in).
        "EXPORT_PATH": "",
        # ZeRO-1 optimizer-state sharding (parallel/mesh.py
        # state_shardings): shard the adamw moments over the data axis;
        # each DP group updates a 1/dp slice and all-gathers new params.
        # Cuts optimizer memory per device by the data-axis size. A TPU
        # scaling extension beyond the reference's DDP.
        "ZERO1": False,
        # accumulate gradients over this many microbatches per optimizer
        # step (lax.scan inside the jitted step; TRAIN.BATCH_SIZE must be
        # divisible by it). Trades wall-clock for activation memory —
        # lets large-resolution recipes keep their effective batch. A
        # TPU extension beyond the reference.
        "GRAD_ACCUM": 1,
        # write checkpoints on a background thread (device fetch stays
        # synchronous for a consistent snapshot; serialisation + disk IO
        # overlap the following train steps).
        "ASYNC_CHECKPOINT": False,
        # on SIGTERM (TPU spot preemption / maintenance drain), save a
        # mid-run checkpoint at the next sync point and exit 0 so the
        # scheduler requeues; AUTO_RESUME replays the interrupted epoch
        # (utils/preemption.py).
        "PREEMPTION_SAVE": True,
        # iterations between multi-host preemption agreement checks (a
        # tiny all-gather on multi-host; a flag read single-host).
        "PREEMPT_SYNC_PERIOD": 10,
        # use Pallas kernels for hot ops when running on TPU.
        "USE_PALLAS": True,
        # STEVE autoregressive rollout: run each decoded token's whole
        # decoder body as ONE Pallas call (ops/pallas/ar_decode.py) —
        # the per-step ~1 GB weight re-stream pipelines continuously and
        # KV-cache reads are bounded by the step index. Same math
        # (bf16 operands, f32 accumulation); TPU backend only.
        "FUSED_AR_STEP": True,
        # device-resident preprocessing (north-star data path): eval
        # frame pipelines ship uint8 pixels (4x smaller H2D) and the
        # jitted step normalises on device (ops/preprocess.py), fusing
        # (x/255-mean)/std into the stem. Host does decode+resize+crop
        # only. Applies to frame datasets with the native decoder; the
        # float path is the fallback. Labeled numerics note: the uint8
        # path rounds the post-resize bilinear result to the nearest
        # byte (a <=0.5/255/std per-pixel quantization the f32/reference
        # paths, which resize in float, do not perform). Half an ULP of
        # already-8-bit source data — defensible default-on, but a
        # deviation in the FAST_GELU/DECODE_DCT_SCALE class, not an
        # identity.
        "DEVICE_PREPROCESS": True,
        # allow libjpeg DCT-scaled decode in the uint8 eval path when
        # the source is >=2x the target (decodes at 1/2..1/8 resolution;
        # an area-average-then-bilinear filter instead of the reference's
        # full-res bilinear — a labeled decode variant, off by default).
        "DECODE_DCT_SCALE": False,
        # tanh-approximate gelu in MLPs (MXU-adjacent VPU saver; ~1e-4
        # output delta vs the exact erf gelu the reference uses)
        "FAST_GELU": False,
        # int8 serving mode (ops/quant.py): the transformer dense layers
        # (qkv/proj/fc1/fc2) run as dynamic W8A8 int8 matmuls on the MXU
        # (2x the bf16 peak on v5e-class parts). Eval/serving only —
        # train steps keep full precision. Param tree unchanged, no
        # calibration. A labeled variant: the parity-tested numerics are
        # the default exact-erf path.
        "INT8_SERVING": False,
        # rematerialise scanned trajectory blocks in training (saves the
        # O(S^2 F) attention residuals; backward recomputes)
        "REMAT": False,
        # jax.profiler device-trace capture (utils/profiler.py)
        "PROFILER": False,
        "PROFILER_START_STEP": 10,
        "PROFILER_NUM_STEPS": 5,
        # run consecutive identical transformer blocks as one lax.scan with
        # stacked params (constant compile size/time in depth).
        "SCAN_LAYERS": True,
    },
}


def _build_default_cfg() -> CfgNode:
    cfg = CfgNode(_DEFAULTS)
    custom_config.add_custom_config(cfg)
    return cfg


_C = _build_default_cfg()


def assert_and_infer_cfg(cfg: CfgNode) -> CfgNode:
    """Validate and finalise a merged config.

    Mirrors the reference's checks (reference defaults.py:1217-1242).
    """
    if cfg.BN.USE_PRECISE_STATS:
        assert cfg.BN.NUM_BATCHES_PRECISE >= 0
    assert cfg.TRAIN.CHECKPOINT_TYPE in ["pytorch", "caffe2"]
    assert cfg.NUM_GPUS == 0 or cfg.TRAIN.BATCH_SIZE % cfg.NUM_GPUS == 0
    assert cfg.TEST.CHECKPOINT_TYPE in ["pytorch", "caffe2"]
    assert cfg.NUM_GPUS == 0 or cfg.TEST.BATCH_SIZE % cfg.NUM_GPUS == 0
    assert cfg.RESNET.NUM_GROUPS > 0
    assert cfg.RESNET.WIDTH_PER_GROUP > 0
    assert cfg.RESNET.WIDTH_PER_GROUP % cfg.RESNET.NUM_GROUPS == 0
    if cfg.SOLVER.BASE_LR_SCALE_NUM_SHARDS:
        cfg.SOLVER.BASE_LR *= cfg.NUM_SHARDS
        cfg.SOLVER.WARMUP_START_LR *= cfg.NUM_SHARDS
        cfg.SOLVER.COSINE_END_LR *= cfg.NUM_SHARDS
    assert cfg.SHARD_ID < cfg.NUM_SHARDS
    return cfg


def get_cfg() -> CfgNode:
    """Return a fresh copy of the default config."""
    return _C.clone()
