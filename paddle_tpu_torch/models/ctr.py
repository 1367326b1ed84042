"""CTR models built through the port's fluid layers: DeepFM over sparse
categorical fields.

Counterpart of paddle_tpu/models/ctr.py, the builders of
examples/ctr_deepfm_sparse.py (reference: BASELINE.json's CTR workload,
paddle/operators/lookup_table_op.cc SelectedRows grads).  DeepFM [Guo et
al. 2017]: a factorization machine and a deep MLP sharing one set of
field embeddings.  The FM second-order term uses the O(F·D) identity
0.5 * ((Σ_f v_f)² − Σ_f v_f²) rather than the O(F²·D) pairwise
products.  With `is_sparse` the two tables' grads are SelectedRows, and
the optimizer updates them from the rows the batch touched.
"""

from ..fluid import layers

__all__ = ["deepfm", "deepfm_ctr"]


def deepfm(field_ids, num_features, num_fields, embed_dim=8,
           hidden_sizes=(64, 32), is_sparse=True):
    """DeepFM logits from a [batch, num_fields] int64 id tensor.

    Ids index one shared feature space (offset per field upstream, the
    usual CTR encoding).  Returns the [batch, 1] pre-sigmoid logit:
    first-order + FM second-order + deep MLP.
    """
    # shared second-order embeddings: [b, F, D]
    emb = layers.embedding(input=field_ids,
                           size=[num_features, embed_dim],
                           is_sparse=is_sparse)
    # first-order per-feature weights: [b, F, 1] -> [b, 1]
    first = layers.embedding(input=field_ids, size=[num_features, 1],
                             is_sparse=is_sparse)
    first_sum = layers.reduce_sum(first, dim=1)

    # FM second order: 0.5 * ((sum_f v)^2 - sum_f v^2), summed over D
    sum_v = layers.reduce_sum(emb, dim=1)                    # [b, D]
    sum_sq = layers.square(sum_v)
    sq_sum = layers.reduce_sum(layers.square(emb), dim=1)    # [b, D]
    second = layers.scale(
        layers.reduce_sum(
            layers.elementwise_sub(x=sum_sq, y=sq_sum),
            dim=1, keep_dim=True),
        scale=0.5)                                           # [b, 1]

    # deep tower over the flattened embedding block
    deep = layers.reshape(x=emb,
                          shape=[-1, num_fields * embed_dim])
    for width in hidden_sizes:
        deep = layers.fc(input=deep, size=width, act="relu")
    deep_out = layers.fc(input=deep, size=1, act=None)

    return layers.elementwise_add(
        x=layers.elementwise_add(x=first_sum, y=second), y=deep_out)


def deepfm_ctr(field_ids, label, num_features, num_fields, embed_dim=8,
               hidden_sizes=(64, 32), is_sparse=True):
    """Full CTR head: (avg_logloss, predict_prob) for a float32 [b, 1]
    click label."""
    logit = deepfm(field_ids, num_features, num_fields,
                   embed_dim=embed_dim, hidden_sizes=hidden_sizes,
                   is_sparse=is_sparse)
    loss = layers.sigmoid_cross_entropy_with_logits(x=logit, label=label)
    avg_loss = layers.mean(x=loss)
    predict = layers.sigmoid(x=logit)
    return avg_loss, predict
