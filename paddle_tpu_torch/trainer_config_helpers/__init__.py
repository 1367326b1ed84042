"""trainer_config_helpers — the original v2 config DSL surface.

reference: python/paddle/trainer_config_helpers/layers.py (7.5k LoC of
`*_layer` functions), activations.py, poolings.py, attrs.py,
optimizers.py, networks.py.  Counterpart of
paddle_tpu/trainer_config_helpers, with the same names: every `*_layer`
name maps onto the port's `v2.layer` (same call signatures for the
common arguments, one implementation underneath), and every evaluator
of `v2.evaluator` is re-exported.  A name whose op the port does not
register yet raises NotImplementedError naming its ROADMAP item, as it
does in v2.  A config written for the port imports
`paddle_tpu_torch.trainer_config_helpers` and names its data provider
in the port's package (`paddle_tpu_torch.dataset.uci_housing_provider`).
"""

from ..v2 import activation as _act
from ..v2 import attr as _attr
from ..v2 import layer as _layer
from ..v2 import networks as _networks
from ..v2 import optimizer as _optimizer
from ..v2 import pooling as _pooling
from ..v2.data_type import (dense_vector, integer_value,  # noqa: F401
                            integer_value_sequence, dense_vector_sequence)
from .config import (settings, outputs,  # noqa: F401
                     define_py_data_sources2)

# optimizers (reference: trainer_config_helpers/optimizers.py)
MomentumOptimizer = _optimizer.Momentum
AdamOptimizer = _optimizer.Adam
AdamaxOptimizer = _optimizer.Adamax
AdaGradOptimizer = _optimizer.AdaGrad
DecayedAdaGradOptimizer = _optimizer.DecayedAdaGrad
AdaDeltaOptimizer = _optimizer.AdaDelta
RMSPropOptimizer = _optimizer.RMSProp

# activations (reference: trainer_config_helpers/activations.py)
TanhActivation = _act.Tanh
SigmoidActivation = _act.Sigmoid
SoftmaxActivation = _act.Softmax
IdentityActivation = _act.Identity
LinearActivation = _act.Linear
ReluActivation = _act.Relu
BReluActivation = _act.BRelu
SoftReluActivation = _act.SoftRelu
STanhActivation = _act.STanh
AbsActivation = _act.Abs
SquareActivation = _act.Square
ExpActivation = _act.Exp
LogActivation = _act.Log

# poolings (reference: trainer_config_helpers/poolings.py)
MaxPooling = _pooling.Max
AvgPooling = _pooling.Avg
SumPooling = _pooling.Sum
SqrtNPooling = _pooling.SquareRootN

# attrs (reference: trainer_config_helpers/attrs.py)
ParamAttr = _attr.Param
ParameterAttribute = _attr.Param
ExtraAttr = _attr.Extra
ExtraLayerAttribute = _attr.Extra

# layers (reference: trainer_config_helpers/layers.py *_layer funcs)
def data_layer(name, size=None, type=None, height=None, width=None,
               depth=None, **kw):
    """reference: layers.py data_layer(name, size[, depth, height,
    width]) — the DSL spelling takes a flat size (+ optional
    volumetric/image dims); the v2 spelling takes an InputType.  Both
    accepted here."""
    if type is None:
        if size is None:
            raise ValueError("data_layer needs size= or type=")
        if height and width:
            spatial = (depth or 1) * height * width
            if size % spatial:
                raise ValueError(
                    "data_layer size %d is not divisible by the "
                    "%s dims %s" % (size,
                                    "depth*height*width" if depth
                                    else "height*width", spatial))
            channels = size // spatial
            from ..v2.data_type import dense_array

            shape = ([channels, depth, height, width] if depth
                     else [channels, height, width])
            type = dense_array(size, shape)
        else:
            type = dense_vector(size)
    return _layer.data(name=name, type=type, **kw)
fc_layer = _layer.fc
embedding_layer = _layer.embedding
img_conv_layer = _layer.img_conv
img_pool_layer = _layer.img_pool
batch_norm_layer = _layer.batch_norm
lstmemory = _layer.lstmemory
grumemory = _layer.grumemory
pooling_layer = _layer.pool
first_seq = _layer.first_seq
last_seq = _layer.last_seq
concat_layer = _layer.concat
seq_concat_layer = _layer.seq_concat
dropout_layer = _layer.dropout
addto_layer = _layer.addto
classification_cost = _layer.classification_cost
cross_entropy = _layer.cross_entropy_cost
cross_entropy_cost = _layer.cross_entropy_cost
regression_cost = _layer.regression_cost
square_error_cost = _layer.square_error_cost
mse_cost = _layer.mse_cost
crf_layer = _layer.crf
crf_decoding_layer = _layer.crf_decoding
maxid_layer = _layer.max_id
expand_layer = _layer.expand
cos_sim = _layer.cos_sim
scaling_layer = _layer.scaling
slope_intercept_layer = _layer.slope_intercept
sum_cost = _layer.sum_cost
trans_layer = _layer.trans
mixed_layer = _layer.mixed
full_matrix_projection = _layer.full_matrix_projection
identity_projection = _layer.identity_projection
table_projection = _layer.table_projection
dotmul_projection = _layer.dotmul_projection
context_projection = _layer.context_projection

trans_full_matrix_projection = _layer.trans_full_matrix_projection
scaling_projection = _layer.scaling_projection
slice_projection = _layer.slice_projection
conv_projection = _layer.conv_projection
dotmul_operator = _layer.dotmul_operator
conv_operator = _layer.conv_operator

# recurrent surface
StaticInput = _layer.StaticInput
SubsequenceInput = _layer.SubsequenceInput
GeneratedInput = _layer.GeneratedInput
memory = _layer.memory
recurrent_group = _layer.recurrent_group
beam_search = _layer.beam_search
get_output_layer = _layer.get_output_layer
eos_layer = _layer.eos_layer
gru_step_layer = _layer.gru_step_layer
gru_step_naive_layer = _layer.gru_step_naive_layer
lstm_step_layer = _layer.lstm_step_layer
recurrent_layer = _layer.recurrent

# extended zoo (reference *_layer names)
repeat_layer = _layer.repeat
seq_reshape_layer = _layer.seq_reshape
interpolation_layer = _layer.interpolation
power_layer = _layer.power
sum_to_one_norm_layer = _layer.sum_to_one_norm
row_l2_norm_layer = _layer.row_l2_norm
dot_prod_layer = _layer.dot_prod
l2_distance_layer = _layer.l2_distance
clip_layer = _layer.clip
resize_layer = _layer.resize
switch_order_layer = _layer.switch_order
scale_shift_layer = _layer.scale_shift
sub_seq_layer = _layer.sub_seq
seq_slice_layer = _layer.seq_slice
kmax_seq_score_layer = _layer.kmax_seq_score
sub_nested_seq_layer = _layer.sub_nested_seq
factorization_machine = _layer.factorization_machine
gated_unit_layer = _layer.gated_unit
tensor_layer = _layer.tensor
selective_fc_layer = _layer.selective_fc
maxout_layer = _layer.maxout
spp_layer = _layer.spp
img_cmrnorm_layer = _layer.img_cmrnorm
cross_channel_norm_layer = _layer.cross_channel_norm
img_pool3d_layer = _layer.img_pool3d
img_conv3d_layer = _layer.img_conv3d
block_expand_layer = _layer.block_expand
bilinear_interp_layer = _layer.bilinear_interp
rotate_layer = _layer.rotate
out_prod_layer = _layer.out_prod
linear_comb_layer = _layer.linear_comb
convex_comb_layer = _layer.convex_comb
conv_shift_layer = _layer.conv_shift
pad_layer = _layer.pad
crop_layer = _layer.crop
scale_sub_region_layer = _layer.scale_sub_region
prelu_layer = _layer.prelu
multiplex_layer = _layer.multiplex
row_conv_layer = _layer.row_conv
sampling_id_layer = _layer.sampling_id
printer_layer = _layer.printer

# costs
hsigmoid = _layer.hsigmoid
nce_layer = _layer.nce
ctc_layer = _layer.ctc
warp_ctc_layer = _layer.warp_ctc
rank_cost = _layer.rank_cost
lambda_cost = _layer.lambda_cost
cross_entropy_with_selfnorm = _layer.cross_entropy_with_selfnorm
multi_binary_label_cross_entropy = _layer.multi_binary_label_cross_entropy
huber_regression_cost = _layer.huber_regression_cost
huber_classification_cost = _layer.huber_classification_cost
smooth_l1_cost = _layer.smooth_l1_cost

# detection
priorbox_layer = _layer.priorbox
roi_pool_layer = _layer.roi_pool
detection_output_layer = _layer.detection_output
multibox_loss_layer = _layer.multibox_loss

# networks (reference: trainer_config_helpers/networks.py)
simple_img_conv_pool = _networks.simple_img_conv_pool
img_conv_group = _networks.img_conv_group
sequence_conv_pool = _networks.sequence_conv_pool
simple_lstm = _networks.simple_lstm
bidirectional_lstm = _networks.bidirectional_lstm
simple_gru = _networks.simple_gru
simple_gru2 = _networks.simple_gru2
lstmemory_unit = _networks.lstmemory_unit
lstmemory_group = _networks.lstmemory_group
gru_unit = _networks.gru_unit
gru_group = _networks.gru_group
bidirectional_gru = _networks.bidirectional_gru
simple_attention = _networks.simple_attention
dot_product_attention = _networks.dot_product_attention
multi_head_attention = _networks.multi_head_attention
small_vgg = _networks.small_vgg
vgg_16_network = _networks.vgg_16_network

__all__ = [n for n in dir() if not n.startswith("_")]

# evaluators (reference: trainer_config_helpers/evaluators.py) — every
# name in the v2 evaluator DSL, kept in sync automatically
from ..v2 import evaluator as _evaluator  # noqa: E402

globals().update({n: getattr(_evaluator, n)
                  for n in _evaluator.__all__})

__all__ = [n for n in dir() if not n.startswith("_")]
