"""Text models built through the port's fluid layers.

Counterpart of paddle_tpu/models/text.py (reference:
benchmark/paddle/rnn/rnn.py, tests/book/
test_understand_sentiment_dynamic_lstm.py,
test_understand_sentiment_conv.py, tests/book/test_machine_translation.py,
tests/book/test_word2vec.py): the stacked-LSTM classifier that bench.py
trains as `BENCH_MODEL=lstm`, the sequence-convolution classifier of the
sentiment book test, the seq2seq translation model of the
machine-translation book test and the word2vec N-gram model.
"""

from ..fluid import layers, nets

__all__ = ["stacked_lstm_text_classifier", "conv_text_classifier",
           "seq2seq", "word2vec_ngram"]


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


def conv_text_classifier(data, dict_dim, class_dim=2, emb_dim=128,
                         hid_dim=128):
    """The sentiment book test's convolution net: an embedding, two
    sequence_conv_pool branches (filters 3 and 4, tanh, max pool) and a
    softmax fc over both.  Returns probabilities [batch, class_dim]."""
    emb = layers.embedding(input=data, size=[dict_dim, emb_dim])
    conv_3 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                     filter_size=3, act="tanh",
                                     pool_type="max")
    conv_4 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                     filter_size=4, act="tanh",
                                     pool_type="max")
    return layers.fc(input=[conv_3, conv_4], size=class_dim, act="softmax")


def seq2seq(src, trg_in, src_dict_size, trg_dict_size, emb_dim=32,
            hidden_dim=32, encoder_depth=1):
    """Encoder-decoder translation model, the teacher-forced training
    path (reference: tests/book/test_machine_translation.py): an LSTM
    encoder over the source embedding, and a DynamicRNN decoder seeded
    from the encoder's last state whose step runs an fc over the target
    embedding and its memory, then the softmax over the target
    dictionary.  Returns the per-step probabilities (ragged, aligned
    with `trg_in`)."""
    src_emb = layers.embedding(input=src, size=[src_dict_size, emb_dim])
    enc_proj = layers.fc(input=src_emb, size=hidden_dim * 4)
    enc_hidden, _ = layers.dynamic_lstm(input=enc_proj,
                                        size=hidden_dim * 4)
    for _ in range(1, encoder_depth):
        enc_proj = layers.fc(input=enc_hidden, size=hidden_dim * 4)
        enc_hidden, _ = layers.dynamic_lstm(input=enc_proj,
                                            size=hidden_dim * 4)
    enc_last = layers.sequence_last_step(input=enc_hidden)  # [B, hid]

    trg_emb = layers.embedding(input=trg_in, size=[trg_dict_size, emb_dim])

    rnn = layers.DynamicRNN()
    with rnn.block():
        cur = rnn.step_input(trg_emb)
        mem = rnn.memory(init=enc_last)
        out = layers.fc(input=[cur, mem], size=hidden_dim, act="tanh")
        prob = layers.fc(input=out, size=trg_dict_size, act="softmax")
        rnn.update_memory(mem, out)
        rnn.step_output(prob)
    return rnn.outputs[0]


def word2vec_ngram(words, dict_size, emb_dim=32, hidden_size=256,
                   shared_embedding=True):
    """The word2vec book test's N-gram language model: each context word
    (a dense int64 [batch, 1] var) embedded, by one shared table
    "shared_w" unless `shared_embedding` is off, concatenated, a sigmoid
    fc and a softmax fc over the dictionary."""
    embs = [layers.embedding(
        input=w, size=[dict_size, emb_dim],
        param_attr="shared_w" if shared_embedding else None)
        for w in words]
    concat = layers.concat(input=embs, axis=1)
    hidden = layers.fc(input=concat, size=hidden_size, act="sigmoid")
    return layers.fc(input=hidden, size=dict_size, act="softmax")
