"""The Paddle book's programs, built once for both packages: each builder
takes the `fluid` module (the JAX package's or the port's) and builds the
same program in fresh programs, as `build_mlp(fluid)` in
`tests/test_torch_fluid_mnist.py` does. Plain numpy and no JAX, so
`chip_smoke.py` imports it too.

Each builder returns a `Book`: the main and startup programs, the loss,
the other fetches, and `feed(batch, rng)`, which draws a batch of the
feed from a `numpy.random.RandomState`.

- `fit_a_line`: fc(13 -> 1), square_error_cost, mean, SGD;
- `recognize_digits`: the book's convolutional_neural_network (two conv
  5 x 5 + pool 2 blocks, 20 then 50 filters with relu, a batch_norm after
  the first), fc(10, softmax), cross_entropy, Adam 0.001;
- `recommender_system`: user and movie embedding towers, cos_sim scaled
  to the 1-5 ratings, square_error_cost, Adam;
- `understand_sentiment`: the book's stacked_lstm_net (embedding, fc,
  `stacked` dynamic_lstm layers with every second one reversed, each fc
  after the first over the previous fc and LSTM outputs, the max over
  time of the last fc and LSTM outputs, concatenated, fc(2, softmax),
  cross_entropy, Adagrad 0.002) over padded [B, T] ids, with an optional
  Length feed that every `lstm` op reads (ragged rows);
- `machine_translation`: a dynamic_gru encoder and teacher-forced
  decoder with dot-product attention, softmax_with_cross_entropy, Adam;
- `convolution_net`: the book's other sentiment model (embedding, two
  `nets.sequence_conv_pool` of filter sizes 3 and 4 with tanh and sqrt
  pooling, fc(2, softmax) over both, cross_entropy, accuracy, Adagrad
  0.002) with a streaming `auc` op on the positive class, its histograms
  persistable int vars, so the AUC runs over every step so far.
"""
import collections

import numpy as np

Book = collections.namedtuple("Book", "main startup loss fetch feed")

#: understand_sentiment at the book's widths: a vocabulary of the order of
#: the book's IMDB dictionary, embedding 128, fc and LSTM size 512 (hidden
#: 128), 3 stacked layers, 2 classes
SENTIMENT = dict(vocab=5000, emb=128, hid=512, stacked=3, classes=2)
#: convolution_net at the book's widths: embedding 128, 512 filters
CONV_SENTIMENT = dict(vocab=SENTIMENT["vocab"], emb=128, filters=512,
                      classes=2)
#: the streaming AUC's thresholds (num_thresholds + 1 buckets)
AUC_THRESHOLDS = 4095


def _programs(fluid, seed):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    return main, startup


def fit_a_line(fluid, lr=0.001, seed=3):
    main, startup = _programs(fluid, seed)
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        x = L.data(name="x", shape=[13], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        pred = L.fc(input=x, size=1, act=None)
        loss = L.mean(L.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)

    def feed(batch, rng):
        x = rng.randn(batch, 13).astype("float32")
        w = np.linspace(-1.0, 1.0, 13).astype("float32")
        return {"x": x, "y": (x @ w + 0.5).reshape(-1, 1).astype("float32")}

    return Book(main, startup, loss, [pred], feed)


def recognize_digits(fluid, lr=0.001, seed=5):
    main, startup = _programs(fluid, seed)
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        img = L.data(name="img", shape=[1, 28, 28], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        h = L.conv2d(input=img, num_filters=20, filter_size=5, act="relu")
        h = L.pool2d(input=h, pool_size=2, pool_stride=2, pool_type="max")
        h = L.batch_norm(h)
        h = L.conv2d(input=h, num_filters=50, filter_size=5, act="relu")
        h = L.pool2d(input=h, pool_size=2, pool_stride=2, pool_type="max")
        pred = L.fc(input=h, size=10, act="softmax")
        loss = L.mean(L.cross_entropy(input=pred, label=label))
        acc = L.accuracy(input=pred, label=label)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)

    def feed(batch, rng):
        y = rng.randint(0, 10, (batch, 1)).astype("int64")
        x = rng.rand(batch, 1, 28, 28).astype("float32") * 0.1
        for i in range(batch):
            r = 2 * int(y[i, 0]) + 4
            x[i, 0, r:r + 3, 4:24] += 1.0
        return {"img": x, "label": y}

    return Book(main, startup, loss, [acc], feed)


def recommender_system(fluid, users=944, movies=3953, dim=32, lr=5e-3,
                       seed=23):
    main, startup = _programs(fluid, seed)
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        uid = L.data(name="uid", shape=[1], dtype="int64")
        mid = L.data(name="mid", shape=[1], dtype="int64")
        rating = L.data(name="rating", shape=[1], dtype="float32")
        u = L.fc(L.reshape(L.embedding(uid, size=[users, dim]), [-1, dim]),
                 size=dim, act="tanh")
        m = L.fc(L.reshape(L.embedding(mid, size=[movies, dim]), [-1, dim]),
                 size=dim, act="tanh")
        pred = L.scale(L.cos_sim(u, m), scale=5.0)
        loss = L.mean(L.square_error_cost(input=pred, label=rating))
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)

    def feed(batch, rng):
        return {"uid": rng.randint(1, users, (batch, 1)).astype("int64"),
                "mid": rng.randint(1, movies, (batch, 1)).astype("int64"),
                "rating": rng.randint(1, 6, (batch, 1)).astype("float32")}

    return Book(main, startup, loss, [pred], feed)


def _read_length(program, length):
    """Make the `lstm` op just appended to `program` read the Length
    feed (`dynamic_lstm` has no argument for it)."""
    op = program.global_block().ops[-1]
    assert op.type == "lstm", op.type
    op.input_names["Length"] = [length.name]


def understand_sentiment(fluid, seq, vocab=SENTIMENT["vocab"],
                         emb=SENTIMENT["emb"], hid=SENTIMENT["hid"],
                         stacked=SENTIMENT["stacked"],
                         classes=SENTIMENT["classes"], ragged=False,
                         lr=0.002, seed=19):
    """The book's stacked_lstm_net over padded [B, seq] ids; with
    `ragged`, a `length` [B] feed that every `lstm` op reads."""
    main, startup = _programs(fluid, seed)
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        words = L.data(name="words", shape=[seq], dtype="int64")
        label = L.data(name="label", shape=[1], dtype="int64")
        length = L.data(name="length", shape=[], dtype="int64") \
            if ragged else None
        e = L.embedding(words, size=[vocab, emb])
        fc = L.fc(input=e, size=hid, num_flatten_dims=2)
        lstm, _ = L.dynamic_lstm(input=fc, size=hid)
        if ragged:
            _read_length(main, length)
        for i in range(2, stacked + 1):
            fc = L.fc(input=[fc, lstm], size=hid, num_flatten_dims=2)
            lstm, _ = L.dynamic_lstm(input=fc, size=hid,
                                     is_reverse=(i % 2) == 0)
            if ragged:
                _read_length(main, length)
        pooled = L.concat([L.reduce_max(fc, dim=1), L.reduce_max(lstm, dim=1)],
                          axis=1)
        pred = L.fc(input=pooled, size=classes, act="softmax")
        loss = L.mean(L.cross_entropy(input=pred, label=label))
        acc = L.accuracy(input=pred, label=label)
        fluid.optimizer.Adagrad(learning_rate=lr).minimize(loss)

    def feed(batch, rng):
        out = {"words": rng.randint(0, vocab, (batch, seq)).astype("int64"),
               "label": rng.randint(0, classes, (batch, 1)).astype("int64")}
        if ragged:
            lens = rng.randint(1, seq + 1, batch)
            lens[0] = seq
            out["length"] = lens.astype("int64")
        return out

    return Book(main, startup, loss, [acc], feed)


def machine_translation(fluid, seq=8, src_vocab=200, trg_vocab=200, hid=32,
                        lr=5e-3, seed=29):
    main, startup = _programs(fluid, seed)
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        src = L.data(name="src", shape=[seq], dtype="int64")
        trg_in = L.data(name="trg_in", shape=[seq], dtype="int64")
        trg_out = L.data(name="trg_out", shape=[seq, 1], dtype="int64")
        enc = L.dynamic_gru(L.fc(L.embedding(src, size=[src_vocab, hid]),
                                 size=3 * hid, num_flatten_dims=2), size=hid)
        dec = L.dynamic_gru(L.fc(L.embedding(trg_in, size=[trg_vocab, hid]),
                                 size=3 * hid, num_flatten_dims=2), size=hid)
        attn = L.softmax(L.matmul(dec, enc, transpose_y=True))
        feat = L.concat([dec, L.matmul(attn, enc)], axis=2)
        logits = L.fc(feat, size=trg_vocab, num_flatten_dims=2)
        loss = L.mean(L.softmax_with_cross_entropy(logits, trg_out))
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)

    def feed(batch, rng):
        return {"src": rng.randint(0, src_vocab, (batch, seq)).astype(
                    "int64"),
                "trg_in": rng.randint(0, trg_vocab, (batch, seq)).astype(
                    "int64"),
                "trg_out": rng.randint(0, trg_vocab, (batch, seq, 1)).astype(
                    "int64")}

    return Book(main, startup, loss, [], feed)


def convolution_net(fluid, seq, vocab=CONV_SENTIMENT["vocab"],
                    emb=CONV_SENTIMENT["emb"],
                    filters=CONV_SENTIMENT["filters"],
                    classes=CONV_SENTIMENT["classes"], lr=0.002, seed=31):
    """The book's convolution_net over padded [B, seq] ids, every row
    full (`sequence_conv_pool` passes no Length), with a streaming `auc`
    op appended by hand (no reference layer emits it): its StatPos and
    StatNeg are persistable int64 vars of AUC_THRESHOLDS + 1 buckets,
    written back by the op. Fetches: accuracy, then the AUC."""
    main, startup = _programs(fluid, seed)
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        words = L.data(name="words", shape=[seq], dtype="int64")
        label = L.data(name="label", shape=[1], dtype="int64")
        e = L.embedding(words, size=[vocab, emb])
        conv_3 = fluid.nets.sequence_conv_pool(
            input=e, num_filters=filters, filter_size=3, act="tanh",
            pool_type="sqrt")
        conv_4 = fluid.nets.sequence_conv_pool(
            input=e, num_filters=filters, filter_size=4, act="tanh",
            pool_type="sqrt")
        pred = L.fc(input=[conv_3, conv_4], size=classes, act="softmax")
        loss = L.mean(L.cross_entropy(input=pred, label=label))
        acc = L.accuracy(input=pred, label=label)
        stats = [L.create_global_var([AUC_THRESHOLDS + 1], 0, "int64",
                                     persistable=True, name=n)
                 for n in ("auc_stat_pos", "auc_stat_neg")]
        block = main.global_block()
        auc = block.create_var(name="auc", shape=[1], dtype="float32")
        block.append_op(type="auc",
                        inputs={"Predict": [pred], "Label": [label],
                                "StatPos": [stats[0]],
                                "StatNeg": [stats[1]]},
                        outputs={"AUC": [auc], "StatPosOut": [stats[0]],
                                 "StatNegOut": [stats[1]]},
                        attrs={"num_thresholds": AUC_THRESHOLDS})
        fluid.optimizer.Adagrad(learning_rate=lr).minimize(loss)

    def feed(batch, rng):
        return {"words": rng.randint(0, vocab, (batch, seq)).astype("int64"),
                "label": rng.randint(0, classes, (batch, 1)).astype("int64")}

    return Book(main, startup, loss, [acc, auc], feed)
