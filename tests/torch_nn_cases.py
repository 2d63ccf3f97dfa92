"""The op cases of the book slice: the rest of the reference's `nn_ops`
(35 types), `loss_ops` (18), `linalg_ops` (22) and `rnn_unit_ops` (6).
`tests/test_torch_nn_extra_ops.py`, `tests/test_torch_linalg_loss_ops.py`
and `tests/test_torch_rnn_ops.py` hold each against the JAX package on
the CPU; `chip_smoke.py` phase 19 leg d, the card against the CPU. Plain
numpy and no JAX, so the card's machine imports it too.

`CASES`: name -> (op type, {slot: [numpy maker]}, attrs, float input
slots to differentiate, batch-carrying slots for a -1 inference check).
A maker takes a `numpy.random.RandomState`; `inputs(name)` draws a
case's inputs from the state seeded by its position among the names.
`MODULE`: op type -> the reference file that registers it."""
import numpy as np


def _f(*shape, scale=1.0):
    return lambda r: (r.randn(*shape) * scale).astype("float32")


def _u(lo, hi, *shape):
    return lambda r: r.uniform(lo, hi, size=shape).astype("float32")


def _i(high, *shape, low=0, dtype="int64"):
    return lambda r: r.randint(low, high, size=shape).astype(dtype)


def _c(v, dtype="float32"):
    return lambda r: np.asarray(v, dtype)


def _bits(*shape):
    return lambda r: r.randint(0, 2, size=shape).astype("float32")


def _ties(*shape):
    return lambda r: r.randint(0, 4, size=shape).astype("float32")


def _probs(*shape):
    def make(r):
        e = np.exp(r.randn(*shape))
        return (e / e.sum(-1, keepdims=True)).astype("float32")
    return make


def _log_probs(*shape, axis=1):
    def make(r):
        x = r.randn(*shape)
        return (x - np.log(np.exp(x).sum(axis, keepdims=True))).astype(
            "float32")
    return make


def _spd(*shape):
    def make(r):
        a = r.randn(*shape)
        n = shape[-1]
        return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype("float32")
    return make


def _chol(n):
    def make(r):
        a = r.randn(n, n)
        return np.linalg.cholesky(a @ a.T + n * np.eye(n)).astype("float32")
    return make


def _tri(n, upper):
    def make(r):
        a = r.randn(n, n) + 3 * np.eye(n)
        return (np.triu(a) if upper else np.tril(a)).astype("float32")
    return make


def _well(*shape):
    def make(r):
        n = shape[-1]
        return (r.randn(*shape) * 0.5 + 2 * np.eye(n)).astype("float32")
    return make


def _lengths(*vals):
    return _c(list(vals), "int64")


#: (B, T, D) of the recurrent cases; the ragged lengths of their rows
B, T, D = 3, 5, 4
RAGGED = (5, 2, 4)
CUDNN_H = 3


def _cudnn_w(layers, dirs, d_in, h):
    n, d = 0, d_in
    for _ in range(layers):
        n += dirs * (4 * h * d + 4 * h * h + 8 * h)
        d = h * dirs
    return _f(n, scale=0.5)


def _lstm_ins(peep=True, proj=None, length=False):
    ins = {"Input": [_f(B, T, 4 * D)],
           "Weight": [_f(proj or D, 4 * D, scale=0.5)],
           "Bias": [_f(1, (7 if peep else 4) * D, scale=0.5)],
           "H0": [_f(B, proj or D)], "C0": [_f(B, D)]}
    if proj:
        ins["ProjWeight"] = [_f(D, proj, scale=0.5)]
    if length:
        ins["Length"] = [_lengths(*RAGGED)]
    return ins


def _gru_ins(length=False, h0=True):
    ins = {"Input": [_f(B, T, 3 * D)], "Weight": [_f(D, 3 * D, scale=0.5)],
           "Bias": [_f(1, 3 * D, scale=0.5)]}
    if h0:
        ins["H0"] = [_f(B, D)]
    if length:
        ins["Length"] = [_lengths(*RAGGED)]
    return ins


_LSTM_DIFF = ["Input", "Weight", "Bias", "H0", "C0"]
_GRU_DIFF = ["Input", "Weight", "Bias", "H0"]

#: name -> (op type, {slot: [numpy maker]}, attrs, float input slots to
#: differentiate, batch-carrying slots for the -1 inference check)
CASES = {
    # -- nn_ops ---------------------------------------------------------------
    "affine_channel": ("affine_channel", {"X": [_f(2, 3, 4, 5)],
                                          "Scale": [_f(3)], "Bias": [_f(3)]},
                       {}, ["X", "Scale", "Bias"], ["X"]),
    "affine_channel_nhwc": ("affine_channel", {"X": [_f(2, 4, 5, 3)],
                                               "Scale": [_f(3)],
                                               "Bias": [_f(3)]},
                            {"data_layout": "NHWC"}, ["X", "Scale"], []),
    "affine_grid": ("affine_grid", {"Theta": [_f(2, 2, 3)]},
                    {"output_shape": [2, 3, 4, 5]}, ["Theta"], []),
    "conv2d_transpose": ("conv2d_transpose",
                         {"Input": [_f(2, 3, 5, 5)],
                          "Filter": [_f(3, 4, 3, 3)]},
                         {"strides": [2, 2], "paddings": [1, 1],
                          "dilations": [1, 1], "groups": 1},
                         ["Input", "Filter"], ["Input"]),
    "conv2d_transpose_groups": ("conv2d_transpose",
                                {"Input": [_f(1, 4, 4, 4)],
                                 "Filter": [_f(4, 3, 3, 3)]},
                                {"strides": [1, 2], "paddings": [0, 1],
                                 "dilations": [2, 1], "groups": 2},
                                ["Input", "Filter"], []),
    "conv3d": ("conv3d", {"Input": [_f(2, 3, 4, 5, 5)],
                          "Filter": [_f(4, 3, 3, 3, 3)]},
               {"strides": [1, 2, 1], "paddings": [1, 0, 1],
                "dilations": [1, 1, 1], "groups": 1}, ["Input", "Filter"],
               ["Input"]),
    "conv3d_transpose": ("conv3d_transpose",
                         {"Input": [_f(1, 2, 3, 4, 4)],
                          "Filter": [_f(2, 3, 3, 3, 3)]},
                         {"strides": [2, 2, 2], "paddings": [1, 1, 1]},
                         ["Input", "Filter"], []),
    "cross_entropy": ("cross_entropy", {"X": [_probs(4, 5)],
                                        "Label": [_i(5, 4, 1)]}, {}, ["X"],
                      ["X", "Label"]),
    "cross_entropy_ignore": ("cross_entropy", {"X": [_probs(6, 5)],
                                               "Label": [_i(3, 6, 1)]},
                             {"ignore_index": 1}, ["X"], []),
    "cross_entropy_soft": ("cross_entropy", {"X": [_probs(4, 5)],
                                             "Label": [_probs(4, 5)]},
                           {"soft_label": True}, ["X", "Label"], []),
    "data_norm": ("data_norm", {"X": [_f(4, 3)],
                                "BatchSize": [_u(8, 12, 3)],
                                "BatchSum": [_f(3)],
                                "BatchSquareSum": [_u(20, 30, 3)]},
                  {"epsilon": 1e-4}, ["X"], ["X"]),
    "fsp": ("fsp", {"X": [_f(2, 3, 4, 5)], "Y": [_f(2, 2, 4, 5)]}, {},
            ["X", "Y"], []),
    "grid_sampler": ("grid_sampler", {"X": [_f(2, 3, 4, 5)],
                                      "Grid": [_u(-1.1, 1.1, 2, 3, 3, 2)]},
                     {}, ["X", "Grid"], []),
    "group_norm": ("group_norm", {"X": [_f(2, 6, 3, 4)], "Scale": [_f(6)],
                                  "Bias": [_f(6)]},
                   {"groups": 3, "epsilon": 1e-5}, ["X", "Scale", "Bias"],
                   []),
    "gru_seq": ("gru_seq", {"Input": [_f(2, 5, 3)],
                            "WeightIh": [_f(12, 3, scale=0.5)],
                            "WeightHh": [_f(12, 4, scale=0.5)],
                            "BiasIh": [_f(12)], "BiasHh": [_f(12)],
                            "InitH": [_f(2, 4)]}, {},
                ["Input", "WeightIh", "WeightHh", "BiasHh", "InitH"],
                ["Input", "InitH"]),
    "gru_seq_reverse": ("gru_seq", {"Input": [_f(2, 5, 3)],
                                    "WeightIh": [_f(12, 3, scale=0.5)],
                                    "WeightHh": [_f(12, 4, scale=0.5)],
                                    "BiasIh": [_f(12)], "BiasHh": [_f(12)],
                                    "InitH": [_f(2, 4)]},
                        {"is_reverse": True}, ["Input", "WeightHh"], []),
    "huber_loss": ("huber_loss", {"X": [_f(4, 3)], "Y": [_f(4, 3)]},
                   {"delta": 0.5}, ["X", "Y"], ["X", "Y"]),
    "im2sequence": ("im2sequence", {"X": [_f(2, 2, 5, 6)]},
                    {"kernels": [2, 3], "strides": [1, 2],
                     "paddings": [1, 0, 0, 1]}, ["X"], []),
    "instance_norm": ("instance_norm", {"X": [_f(2, 3, 4, 5)],
                                        "Scale": [_f(3)], "Bias": [_f(3)]},
                      {"epsilon": 1e-5}, ["X", "Scale", "Bias"], ["X"]),
    "interp_nearest": ("interp_nearest", {"X": [_f(1, 2, 5, 7)]},
                       {"out_h": 3, "out_w": 4}, ["X"], ["X"]),
    "interp_nearest_up": ("interp_nearest", {"X": [_f(1, 2, 3, 5)]},
                          {"out_h": 7, "out_w": 9}, ["X"], []),
    "kldiv_loss": ("kldiv_loss", {"X": [_f(4, 5)],
                                  "Target": [_u(-0.2, 1.0, 4, 5)]}, {},
                   ["X"], []),
    "kldiv_loss_batchmean": ("kldiv_loss", {"X": [_f(4, 5)],
                                            "Target": [_u(0.1, 1.0, 4, 5)]},
                             {"reduction": "batchmean"}, ["X", "Target"],
                             []),
    "kldiv_loss_none": ("kldiv_loss", {"X": [_f(4, 5)],
                                       "Target": [_u(-0.2, 1.0, 4, 5)]},
                        {"reduction": "none"}, ["X"], ["X", "Target"]),
    "lrn": ("lrn", {"X": [_f(2, 6, 3, 3)]},
            {"n": 5, "k": 1.0, "alpha": 1e-2, "beta": 0.75}, ["X"], ["X"]),
    "lstm_seq": ("lstm_seq", {"Input": [_f(2, 5, 3)],
                              "WeightIh": [_f(16, 3, scale=0.5)],
                              "WeightHh": [_f(16, 4, scale=0.5)],
                              "Bias": [_f(16)], "InitH": [_f(2, 4)],
                              "InitC": [_f(2, 4)]}, {},
                 ["Input", "WeightIh", "WeightHh", "Bias", "InitH",
                  "InitC"], ["Input", "InitH", "InitC"]),
    "lstm_seq_reverse": ("lstm_seq", {"Input": [_f(2, 5, 3)],
                                      "WeightIh": [_f(16, 3, scale=0.5)],
                                      "WeightHh": [_f(16, 4, scale=0.5)],
                                      "Bias": [_f(16)], "InitH": [_f(2, 4)],
                                      "InitC": [_f(2, 4)]},
                         {"is_reverse": True}, ["Input", "WeightHh"], []),
    "max_pool2d_with_index": ("max_pool2d_with_index",
                              {"X": [_f(2, 2, 5, 5)]},
                              {"ksize": [3, 3], "strides": [2, 2],
                               "paddings": [1, 1]}, ["X"], ["X"]),
    "max_pool2d_with_index_ties": ("max_pool2d_with_index",
                                   {"X": [_ties(2, 3, 6, 6)]},
                                   {"ksize": [2, 2], "strides": [2, 2],
                                    "paddings": [0, 0]}, ["X"], []),
    "max_pool2d_with_index_ties_pad": ("max_pool2d_with_index",
                                       {"X": [_ties(1, 2, 5, 4)]},
                                       {"ksize": [3, 2], "strides": [1, 2],
                                        "paddings": [1, 1]}, ["X"], []),
    "maxout": ("maxout", {"X": [_f(2, 6, 3, 4)]}, {"groups": 2}, ["X"],
               ["X"]),
    "maxout_ties": ("maxout", {"X": [_ties(2, 3, 4)]},
                    {"groups": 2, "axis": 2}, ["X"], []),
    "norm": ("norm", {"X": [_f(3, 4)]}, {"axis": 1, "epsilon": 1e-10},
             ["X"], ["X"]),
    "one_hot_v2": ("one_hot_v2", {"X": [_i(7, 3, 4, low=-1)]},
                   {"depth": 5}, [], ["X"]),
    "pixel_shuffle": ("pixel_shuffle", {"X": [_f(1, 8, 2, 3)]},
                      {"upscale_factor": 2}, ["X"], ["X"]),
    "pool3d": ("pool3d", {"X": [_f(2, 2, 5, 5, 5)]},
               {"ksize": [3, 3, 3], "strides": [2, 2, 2],
                "paddings": [1, 1, 1], "pooling_type": "max"}, ["X"], ["X"]),
    "pool3d_avg": ("pool3d", {"X": [_f(1, 2, 4, 5, 6)]},
                   {"ksize": [2, 3, 2], "strides": [2, 1, 2],
                    "paddings": [1, 1, 0], "pooling_type": "avg"}, ["X"],
                   []),
    "prelu": ("prelu", {"X": [_f(2, 3, 4)], "Alpha": [_c([0.25])]}, {},
              ["X", "Alpha"], ["X"]),
    "prelu_channel": ("prelu", {"X": [_f(2, 3, 4, 2)], "Alpha": [_f(3)]},
                      {"mode": "channel"}, ["X", "Alpha"], []),
    "prelu_element": ("prelu", {"X": [_f(2, 3, 4)], "Alpha": [_f(3, 4)]},
                      {"mode": "element"}, ["X", "Alpha"], []),
    "row_conv": ("row_conv", {"X": [_f(2, 6, 3)], "Filter": [_f(3, 3)]},
                 {}, ["X", "Filter"], ["X"]),
    "shuffle_channel": ("shuffle_channel", {"X": [_f(2, 6, 2, 2)]},
                        {"group": 3}, ["X"], ["X"]),
    "sigmoid_cross_entropy_with_logits": (
        "sigmoid_cross_entropy_with_logits",
        {"X": [_f(4, 5)], "Label": [_u(0.0, 1.0, 4, 5)]}, {}, ["X", "Label"],
        ["X", "Label"]),
    "sigmoid_cross_entropy_normalize": (
        "sigmoid_cross_entropy_with_logits",
        {"X": [_f(4, 5)], "Label": [_i(2, 4, 5, low=-1, dtype="float32")]},
        {"ignore_index": -1, "normalize": True}, ["X"], []),
    "smooth_l1_loss": ("smooth_l1_loss", {"X": [_f(4, 3)], "Y": [_f(4, 3)]},
                       {"sigma": 2.0}, ["X", "Y"], ["X", "Y"]),
    "space_to_depth": ("space_to_depth", {"X": [_f(1, 2, 4, 6)]},
                       {"blocksize": 2}, ["X"], ["X"]),
    "spectral_norm": ("spectral_norm", {"Weight": [_f(4, 3, 2)],
                                        "U": [_f(4)], "V": [_f(6)]},
                      {"dim": 0, "power_iters": 2}, ["Weight", "U", "V"],
                      []),
    "spectral_norm_dim1": ("spectral_norm", {"Weight": [_f(3, 4, 2)],
                                             "U": [_f(4)], "V": [_f(6)]},
                           {"dim": 1, "power_iters": 1}, ["Weight"], []),
    "spp": ("spp", {"X": [_f(2, 3, 5, 6)]},
            {"pyramid_height": 3, "pooling_type": "max"}, ["X"], ["X"]),
    "spp_avg": ("spp", {"X": [_f(1, 2, 4, 7)]},
                {"pyramid_height": 2, "pooling_type": "avg"}, ["X"], []),
    "square_error_cost": ("square_error_cost", {"X": [_f(4, 3)],
                                                "Y": [_f(4, 3)]}, {},
                          ["X", "Y"], ["X", "Y"]),
    "temporal_shift": ("temporal_shift", {"X": [_f(4, 8, 2, 2)]},
                       {"seg_num": 2, "shift_ratio": 0.25}, ["X"], []),
    "unfold": ("unfold", {"X": [_f(2, 3, 5, 6)]},
               {"kernel_sizes": [2, 3], "strides": [1, 2],
                "paddings": [1, 0, 1, 1], "dilations": [1, 1]}, ["X"],
               ["X"]),
    "unfold_dilated": ("unfold", {"X": [_f(1, 2, 6, 6)]},
                       {"kernel_sizes": [2, 2], "strides": [2, 1],
                        "paddings": [0, 0, 0, 0], "dilations": [2, 2]},
                       ["X"], []),
    # -- loss_ops -------------------------------------------------------------
    "bce_loss": ("bce_loss", {"X": [_u(0.05, 0.95, 4, 3)],
                              "Label": [_bits(4, 3)]}, {}, ["X"],
                 ["X", "Label"]),
    "bpr_loss": ("bpr_loss", {"X": [_f(4, 5)], "Label": [_i(5, 4, 1)]}, {},
                 ["X"], []),
    "center_loss": ("center_loss", {"X": [_f(5, 3)], "Label": [_i(4, 5, 1)],
                                    "Centers": [_f(4, 3)],
                                    "CenterUpdateRate": [_c([0.1])]},
                    {"cluster_num": 4, "alpha": 0.5, "need_update": True},
                    ["X", "Centers"], []),
    "center_loss_rate": ("center_loss", {"X": [_f(5, 3)],
                                         "Label": [_i(4, 5, 1)],
                                         "Centers": [_f(4, 3)],
                                         "CenterUpdateRate": [_c([0.1])]},
                         {"need_update": False}, ["X", "Centers"], []),
    "cos_sim": ("cos_sim", {"X": [_f(4, 5)], "Y": [_f(4, 5)]}, {},
                ["X", "Y"], ["X", "Y"]),
    "cos_sim_one_row": ("cos_sim", {"X": [_f(4, 5)], "Y": [_f(1, 5)]}, {},
                        ["X", "Y"], []),
    "cross_entropy2": ("cross_entropy2", {"X": [_probs(4, 5)],
                                          "Label": [_i(5, 4, 1)]}, {},
                       ["X"], ["X", "Label"]),
    "dice_loss": ("dice_loss", {"X": [_u(0.0, 1.0, 3, 4, 2)],
                                "Label": [_bits(3, 4, 2)]},
                  {"epsilon": 1e-5}, ["X"], ["X", "Label"]),
    "hinge_loss": ("hinge_loss", {"Logits": [_f(5, 1)],
                                  "Labels": [_bits(5, 1)]}, {}, ["Logits"],
                   ["Logits", "Labels"]),
    "l1_loss": ("l1_loss", {"X": [_f(4, 3)], "Y": [_f(4, 3)]}, {},
                ["X", "Y"], ["X", "Y"]),
    "log_loss": ("log_loss", {"Predicted": [_u(0.05, 0.95, 5, 1)],
                              "Labels": [_bits(5, 1)]},
                 {"epsilon": 1e-4}, ["Predicted"], ["Predicted", "Labels"]),
    "margin_rank_loss": ("margin_rank_loss",
                         {"Label": [lambda r: np.sign(r.randn(5, 1)).astype(
                             "float32")],
                          "X1": [_f(5, 1)], "X2": [_f(5, 1)]},
                         {"margin": 0.1}, ["X1", "X2"], []),
    "modified_huber_loss": ("modified_huber_loss",
                            {"X": [_f(6, 1, scale=2.0)], "Y": [_bits(6, 1)]},
                            {}, ["X"], ["X", "Y"]),
    "mse_loss": ("mse_loss", {"X": [_f(4, 3)], "Y": [_f(4, 3)]}, {},
                 ["X", "Y"], ["X", "Y"]),
    "nll_loss": ("nll_loss", {"X": [_log_probs(4, 5)],
                              "Label": [_c([0, 3, -100, 4], "int64")],
                              "Weight": [_u(0.5, 1.5, 5)]}, {},
                 ["X", "Weight"], []),
    "nll_loss_sum_4d": ("nll_loss", {"X": [_log_probs(2, 3, 2, 2)],
                                     "Label": [_i(3, 2, 2, 2)]},
                        {"reduction": "sum"}, ["X"], []),
    "nll_loss_none": ("nll_loss", {"X": [_log_probs(4, 5)],
                                   "Label": [_c([1, 1, 2, 0], "int64")]},
                      {"reduction": "none", "ignore_index": 2}, ["X"], []),
    "npair_loss": ("npair_loss", {"Anchor": [_f(4, 3)],
                                  "Positive": [_f(4, 3)],
                                  "Labels": [_c([0, 1, 0, 2], "float32")]},
                   {"l2_reg": 0.002}, ["Anchor", "Positive"], []),
    "rank_loss": ("rank_loss", {"Label": [_bits(5, 1)], "Left": [_f(5, 1)],
                                "Right": [_f(5, 1)]}, {}, ["Left", "Right"],
                  ["Label", "Left", "Right"]),
    "sigmoid_focal_loss": ("sigmoid_focal_loss",
                           {"X": [_f(4, 3)], "Label": [_i(4, 4, 1)],
                            "FgNum": [_c([3], "int32")]},
                           {"gamma": 2.0, "alpha": 0.25}, ["X"], []),
    "squared_l2_distance": ("squared_l2_distance",
                            {"X": [_f(4, 3)], "Y": [_f(4, 3)]}, {},
                            ["X", "Y"], ["X", "Y"]),
    "squared_l2_distance_bcast": ("squared_l2_distance",
                                  {"X": [_f(4, 2, 3)], "Y": [_f(1, 6)]}, {},
                                  ["X", "Y"], []),
    "teacher_student_sigmoid_loss": (
        "teacher_student_sigmoid_loss",
        {"X": [_f(5, 1, scale=10.0)], "Label": [_u(0.0, 1.0, 5, 1)]},
        {"soft_max_up_bound": 15.0, "soft_max_lower_bound": -15.0}, ["X"],
        ["X", "Label"]),
    # -- linalg_ops -----------------------------------------------------------
    "addcmul": ("addcmul", {"Input": [_f(3, 4)], "Tensor1": [_f(3, 4)],
                            "Tensor2": [_f(3, 4)]}, {"value": 0.5},
                ["Input", "Tensor1", "Tensor2"], []),
    "addmm": ("addmm", {"Input": [_f(3, 5)], "X": [_f(3, 4)],
                        "Y": [_f(4, 5)]}, {"Alpha": 0.5, "Beta": 2.0},
              ["Input", "X", "Y"], []),
    "bilinear_tensor_product": ("bilinear_tensor_product",
                                {"X": [_f(3, 4)], "Y": [_f(3, 5)],
                                 "Weight": [_f(2, 4, 5)],
                                 "Bias": [_f(1, 2)]}, {},
                                ["X", "Y", "Weight", "Bias"], ["X", "Y"]),
    "bincount": ("bincount", {"X": [_i(6, 10)]}, {"minlength": 3}, [], []),
    "bincount_weights": ("bincount", {"X": [_i(6, 10)],
                                      "Weights": [_f(10)]},
                         {"minlength": 8}, ["Weights"], []),
    "bmm": ("bmm", {"X": [_f(2, 3, 4)], "Y": [_f(2, 4, 5)]}, {},
            ["X", "Y"], ["X", "Y"]),
    "cholesky": ("cholesky", {"X": [_spd(2, 3, 3)]}, {}, ["X"], []),
    "cholesky_upper": ("cholesky", {"X": [_spd(3, 3)]}, {"upper": True},
                       ["X"], []),
    "cholesky_solve": ("cholesky_solve", {"X": [_f(3, 2)],
                                          "Y": [_chol(3)]}, {},
                       ["X", "Y"], []),
    "cross": ("cross", {"X": [_f(4, 3)], "Y": [_f(4, 3)]}, {}, ["X", "Y"],
              []),
    "cross_dim0": ("cross", {"X": [_f(3, 4)], "Y": [_f(3, 4)]}, {"dim": 0},
                   ["X", "Y"], []),
    "cumprod": ("cumprod", {"X": [_u(0.5, 1.5, 3, 4)]}, {"dim": 1}, ["X"],
                ["X"]),
    "determinant": ("determinant", {"Input": [_well(2, 3, 3)]}, {},
                    ["Input"], []),
    "dot": ("dot", {"X": [_f(3, 4)], "Y": [_f(3, 4)]}, {}, ["X", "Y"],
            ["X", "Y"]),
    "dot_1d": ("dot", {"X": [_f(4)], "Y": [_f(4)]}, {}, ["X", "Y"], []),
    "histogram": ("histogram", {"X": [_f(20)]}, {"bins": 5}, [], []),
    "histogram_range": ("histogram", {"X": [_f(4, 6)]},
                        {"bins": 4, "min": -1, "max": 1}, [], []),
    "inverse": ("inverse", {"Input": [_well(3, 3)]}, {}, ["Input"], []),
    "kron": ("kron", {"X": [_f(2, 3)], "Y": [_f(3, 2)]}, {}, ["X", "Y"],
             []),
    "logsumexp": ("logsumexp", {"X": [_f(3, 4, 5)]},
                  {"axis": [1, 2], "keepdim": True}, ["X"], ["X"]),
    "logsumexp_all": ("logsumexp", {"X": [_f(3, 4)]}, {}, ["X"], []),
    "matmul_transpose": ("matmul_transpose", {"X": [_f(2, 3, 4)],
                                              "Y": [_f(2, 5, 4)]}, {},
                         ["X", "Y"], ["X", "Y"]),
    "matrix_power": ("matrix_power", {"X": [_f(3, 3, scale=0.5)]},
                     {"n": 3}, ["X"], []),
    "matrix_power_neg": ("matrix_power", {"X": [_well(3, 3)]}, {"n": -2},
                         ["X"], []),
    "mv": ("mv", {"X": [_f(3, 4)], "Vec": [_f(4)]}, {}, ["X", "Vec"], []),
    "outer": ("outer", {"X": [_f(3)], "Y": [_f(4)]}, {}, ["X", "Y"], []),
    "slogdeterminant": ("slogdeterminant", {"Input": [_well(2, 3, 3)]}, {},
                        ["Input"], []),
    "trace": ("trace", {"Input": [_f(3, 4, 5)]},
              {"offset": 1, "axis1": 1, "axis2": 2}, ["Input"], ["Input"]),
    "triangular_solve": ("triangular_solve", {"X": [_tri(3, True)],
                                              "Y": [_f(3, 2)]}, {},
                         ["X", "Y"], []),
    "triangular_solve_lower_t": ("triangular_solve",
                                 {"X": [_tri(3, False)], "Y": [_f(3, 2)]},
                                 {"upper": False, "transpose": True,
                                  "unitriangular": True}, ["X", "Y"], []),
    # -- rnn_unit_ops ---------------------------------------------------------
    "lstm": ("lstm", _lstm_ins(), {}, _LSTM_DIFF, ["Input", "H0", "C0"]),
    "lstm_ragged": ("lstm", _lstm_ins(length=True), {}, _LSTM_DIFF,
                    ["Input", "H0", "C0", "Length"]),
    "lstm_ragged_reverse": ("lstm", _lstm_ins(length=True),
                            {"is_reverse": True}, _LSTM_DIFF, []),
    "lstm_no_peepholes": ("lstm", _lstm_ins(peep=False),
                          {"use_peepholes": False, "cell_clip": 0.8,
                           "gate_activation": "sigmoid",
                           "cell_activation": "relu",
                           "candidate_activation": "identity"},
                          _LSTM_DIFF, []),
    "lstmp": ("lstmp", _lstm_ins(proj=3),
              {"proj_activation": "tanh"}, _LSTM_DIFF + ["ProjWeight"],
              ["Input", "H0", "C0"]),
    "lstmp_ragged_reverse": ("lstmp", _lstm_ins(proj=3, length=True),
                             {"is_reverse": True, "proj_clip": 0.5},
                             _LSTM_DIFF + ["ProjWeight"], []),
    "lstm_unit": ("lstm_unit", {"X": [_f(B, 4 * D)], "C_prev": [_f(B, D)]},
                  {"forget_bias": 1.0}, ["X", "C_prev"], ["X", "C_prev"]),
    "gru": ("gru", _gru_ins(), {}, _GRU_DIFF, ["Input", "H0"]),
    "gru_reverse_origin": ("gru", _gru_ins(),
                           {"is_reverse": True, "origin_mode": True},
                           _GRU_DIFF, []),
    "gru_ragged": ("gru", _gru_ins(length=True), {}, _GRU_DIFF,
                   ["Input", "H0", "Length"]),
    "gru_ragged_reverse": ("gru", _gru_ins(length=True, h0=False),
                           {"is_reverse": True}, ["Input", "Weight", "Bias"],
                           []),
    "gru_unit": ("gru_unit", {"Input": [_f(B, 3 * D)],
                              "HiddenPrev": [_f(B, D)],
                              "Weight": [_f(D, 3 * D, scale=0.5)],
                              "Bias": [_f(1, 3 * D)]},
                 {"activation": 2, "gate_activation": 1},
                 ["Input", "HiddenPrev", "Weight", "Bias"],
                 ["Input", "HiddenPrev"]),
    "gru_unit_origin": ("gru_unit", {"Input": [_f(B, 3 * D)],
                                     "HiddenPrev": [_f(B, D)],
                                     "Weight": [_f(D, 3 * D, scale=0.5)]},
                        {"origin_mode": True, "activation": "relu"},
                        ["Input", "HiddenPrev", "Weight"], []),
    "cudnn_lstm": ("cudnn_lstm", {"Input": [_f(T, B, D)],
                                  "W": [_cudnn_w(1, 1, D, CUDNN_H)],
                                  "InitH": [_f(1, B, CUDNN_H)],
                                  "InitC": [_f(1, B, CUDNN_H)]},
                   {"hidden_size": CUDNN_H, "num_layers": 1},
                   ["Input", "W", "InitH", "InitC"], []),
    "cudnn_lstm_bidirec_ragged": (
        "cudnn_lstm", {"Input": [_f(T, B, D)],
                       "W": [_cudnn_w(2, 2, D, CUDNN_H)],
                       "InitH": [_f(4, B, CUDNN_H)],
                       "InitC": [_f(4, B, CUDNN_H)],
                       "SequenceLength": [_lengths(*RAGGED)]},
        {"hidden_size": CUDNN_H, "num_layers": 2, "is_bidirec": True},
        ["Input", "W", "InitH", "InitC"], []),
}

_NN = set(
    "affine_channel affine_grid conv2d_transpose conv3d conv3d_transpose "
    "cross_entropy data_norm fsp grid_sampler group_norm gru_seq huber_loss "
    "im2sequence instance_norm interp_nearest kldiv_loss lrn lstm_seq "
    "max_pool2d_with_index maxout norm one_hot_v2 pixel_shuffle pool3d "
    "prelu row_conv shuffle_channel sigmoid_cross_entropy_with_logits "
    "smooth_l1_loss space_to_depth spectral_norm spp square_error_cost "
    "temporal_shift unfold".split())
_LOSS = set(
    "bce_loss bpr_loss center_loss cos_sim cross_entropy2 dice_loss "
    "hinge_loss l1_loss log_loss margin_rank_loss modified_huber_loss "
    "mse_loss nll_loss npair_loss rank_loss sigmoid_focal_loss "
    "squared_l2_distance teacher_student_sigmoid_loss".split())
_RNN = {"cudnn_lstm", "gru", "gru_unit", "lstm", "lstm_unit", "lstmp"}


def _module(op_type):
    return ("nn_ops" if op_type in _NN else "loss_ops" if op_type in _LOSS
            else "rnn_unit_ops" if op_type in _RNN else "linalg_ops")


#: op type -> the reference file that registers it
MODULE = {c[0]: _module(c[0]) for c in CASES.values()}


def cases_of(*modules):
    """The case names whose op type the reference registers in one of
    `modules` ("nn_ops", "loss_ops", "linalg_ops", "rnn_unit_ops")."""
    return sorted(n for n, c in CASES.items() if MODULE[c[0]] in modules)


def inputs(name):
    """{slot: [numpy array]} of case `name`."""
    r = np.random.RandomState(sorted(CASES).index(name))
    return {slot: [make(r) for make in ms]
            for slot, ms in CASES[name][1].items()}
