"""Text models built through the port's fluid layers.

Counterpart of paddle_tpu/models/text.py (reference:
benchmark/paddle/rnn/rnn.py, tests/book/
test_understand_sentiment_dynamic_lstm.py): the stacked-LSTM
classifier that bench.py trains as `BENCH_MODEL=lstm`.  The convolution
classifier (`sequence_conv`) and seq2seq (`DynamicRNN`) wait with
ROADMAP A7.
"""

from ..fluid import layers

__all__ = ["stacked_lstm_text_classifier"]


def stacked_lstm_text_classifier(data, dict_dim, class_dim=2,
                                 emb_dim=128, hid_dim=128, stacked_num=2):
    """Embedding, an fc and a dynamic LSTM, then `stacked_num - 1` more
    (fc over the previous fc and LSTM, LSTM), max-pooled over time and
    classified by a softmax fc.  `data` is a ragged int64 sequence of
    word ids; returns probabilities [batch, class_dim]."""
    emb = layers.embedding(input=data, size=[dict_dim, emb_dim])

    fc1 = layers.fc(input=emb, size=hid_dim * 4)
    lstm1, cell1 = layers.dynamic_lstm(input=fc1, size=hid_dim * 4)

    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim * 4)
        lstm, cell = layers.dynamic_lstm(input=fc, size=hid_dim * 4,
                                         is_reverse=False)
        inputs = [fc, lstm]

    fc_last = layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type="max")
    return layers.fc(input=[fc_last, lstm_last], size=class_dim,
                     act="softmax")
