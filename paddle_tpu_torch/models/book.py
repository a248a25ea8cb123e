"""The eight Paddle Book programs of ``tests/test_book.py``, built
through a package's ``fluid`` namespace as that file writes them: the
programs ``chip_smoke.py`` phase 24 trains on the card and the CPU tests
build in both packages.

``fit_a_line``, ``recognize_digits`` (the conv net),
``word2vec``, ``image_classification`` (resnet_cifar10),
``label_semantic_roles`` (db_lstm and the linear-chain CRF),
``recommender_system``, ``rnn_encoder_decoder`` and
``machine_translation`` (its train program). Each builder takes the
package (``paddle_tpu_torch`` by default; a test passes ``paddle_tpu``
to build the same program there) and the program's sizes, whose
defaults are ``tests/test_book.py``'s, and returns a :class:`Book`: the
main and startup programs, a forward clone for test taken before the
optimizer, the loss and the other fetches, the inference model's feeds
and targets, and the train reader with the feed it makes. Under
``unique_name.guard()`` both packages name every variable alike, so one
scope's arrays load into the other's program.

:func:`ctc_tagger` is one further program, built only from sequence
builders the Book does not reach: ``row_conv``, ``warpctc``,
``ctc_greedy_decoder``, ``edit_distance`` and ``sequence_pad`` /
``sequence_unpad``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, List, Optional


@dataclasses.dataclass
class Book:
    name: str
    main: Any
    startup: Any
    test_program: Any
    loss: Any
    fetches: List[Any]
    infer_feeds: List[str]
    infer_targets: List[Any]
    reader: Callable
    feed: Callable
    optimizer: str
    lr: float


def port_package():
    import paddle_tpu_torch
    return paddle_tpu_torch


def _programs(paddle, seed):
    fluid = paddle.fluid
    main, startup = fluid.Program(), fluid.Program()
    if seed is not None:
        main.random_seed = startup.random_seed = seed
    return fluid, main, startup


def batches(book: Book, n: int) -> List[dict]:
    """The first ``n`` feed dicts of ``book``'s train reader, passes
    repeated as the Book's loops repeat them; drawn once, so both sides
    of a comparison take the same arrays."""
    out: List[dict] = []
    while len(out) < n:
        before = len(out)
        for data in book.reader():
            out.append(book.feed(data))
            if len(out) == n:
                break
        if len(out) == before:
            raise ValueError(f"{book.name}: the reader yields no batch")
    return out


def fit_a_line(paddle=None, batch_size=20, seed=None) -> Book:
    paddle = paddle or port_package()
    fluid, main, startup = _programs(paddle, seed)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[13], dtype='float32')
        y_predict = fluid.layers.fc(input=x, size=1, act=None)
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        cost = fluid.layers.square_error_cost(input=y_predict, label=y)
        avg_cost = fluid.layers.mean(cost)
        test_program = main.clone(for_test=True)
        sgd_optimizer = fluid.optimizer.SGD(learning_rate=0.001)
        sgd_optimizer.minimize(avg_cost)
        train_reader = paddle.batch(
            paddle.reader.shuffle(
                paddle.dataset.uci_housing.train(), buf_size=500),
            batch_size=batch_size)
        feeder = fluid.DataFeeder(place=fluid.CPUPlace(), feed_list=[x, y])
    return Book("fit_a_line", main, startup, test_program, avg_cost,
                [avg_cost], ['x'], [y_predict], train_reader, feeder.feed,
                "sgd", 0.001)


def _loss_net(fluid, hidden, label):
    prediction = fluid.layers.fc(input=hidden, size=10, act='softmax')
    loss = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_loss = fluid.layers.mean(loss)
    acc = fluid.layers.accuracy(input=prediction, label=label)
    return prediction, avg_loss, acc


def recognize_digits(paddle=None, batch_size=64, seed=None) -> Book:
    """test_recognize_digits.py's conv variant."""
    paddle = paddle or port_package()
    fluid, main, startup = _programs(paddle, seed)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name='img', shape=[1, 28, 28],
                                dtype='float32')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        conv_pool_1 = fluid.nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=20, pool_size=2,
            pool_stride=2, act="relu")
        conv_pool_1 = fluid.layers.batch_norm(conv_pool_1)
        conv_pool_2 = fluid.nets.simple_img_conv_pool(
            input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
            pool_stride=2, act="relu")
        prediction, avg_loss, acc = _loss_net(fluid, conv_pool_2, label)
        test_program = main.clone(for_test=True)
        optimizer = fluid.optimizer.Adam(learning_rate=0.001)
        optimizer.minimize(avg_loss)
        train_reader = paddle.batch(
            paddle.reader.shuffle(paddle.dataset.mnist.train(), buf_size=500),
            batch_size=batch_size, drop_last=True)
        feeder = fluid.DataFeeder(feed_list=[img, label],
                                  place=fluid.CPUPlace())
    return Book("recognize_digits", main, startup, test_program, avg_loss,
                [avg_loss, acc], ["img"], [prediction], train_reader,
                feeder.feed, "adam", 0.001)


def word2vec(paddle=None, embed_size=32, hidden_size=256, n=5,
             batch_size=32, is_sparse=True, seed=None) -> Book:
    """test_word2vec.py: the N-gram model over a shared embedding."""
    paddle = paddle or port_package()
    fluid, main, startup = _programs(paddle, seed)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        word_dict = paddle.dataset.imikolov.build_dict()
        dict_size = len(word_dict)
        words = [fluid.layers.data(name=nm, shape=[1], dtype='int64')
                 for nm in ('firstw', 'secondw', 'thirdw', 'forthw',
                            'nextw')]
        next_word = words[4]

        def emb(w):
            return fluid.layers.embedding(
                input=w, size=[dict_size, embed_size], dtype='float32',
                is_sparse=is_sparse, param_attr='shared_w')

        concat_embed = fluid.layers.concat(
            input=[emb(w) for w in words[:4]], axis=1)
        hidden1 = fluid.layers.fc(input=concat_embed, size=hidden_size,
                                  act='sigmoid')
        predict_word = fluid.layers.fc(input=hidden1, size=dict_size,
                                       act='softmax')
        cost = fluid.layers.cross_entropy(input=predict_word,
                                          label=next_word)
        avg_cost = fluid.layers.mean(cost)
        test_program = main.clone(for_test=True)
        sgd_optimizer = fluid.optimizer.SGD(learning_rate=0.01)
        sgd_optimizer.minimize(avg_cost)
        train_reader = paddle.batch(
            paddle.dataset.imikolov.train(word_dict, n), batch_size)
        feeder = fluid.DataFeeder(feed_list=words, place=fluid.CPUPlace())
    return Book("word2vec", main, startup, test_program, avg_cost,
                [avg_cost], ['firstw', 'secondw', 'thirdw', 'forthw'],
                [predict_word], train_reader, feeder.feed, "sgd", 0.01)


def resnet_cifar10(fluid, input, depth=32):  # noqa: A002
    def conv_bn_layer(input, ch_out, filter_size, stride, padding,  # noqa: A002
                      act='relu', bias_attr=False):
        tmp = fluid.layers.conv2d(input=input, filter_size=filter_size,
                                  num_filters=ch_out, stride=stride,
                                  padding=padding, act=None,
                                  bias_attr=bias_attr)
        return fluid.layers.batch_norm(input=tmp, act=act)

    def shortcut(input, ch_in, ch_out, stride):  # noqa: A002
        if ch_in != ch_out:
            return conv_bn_layer(input, ch_out, 1, stride, 0, None)
        return input

    def basicblock(input, ch_in, ch_out, stride):  # noqa: A002
        tmp = conv_bn_layer(input, ch_out, 3, stride, 1)
        tmp = conv_bn_layer(tmp, ch_out, 3, 1, 1, act=None, bias_attr=True)
        short = shortcut(input, ch_in, ch_out, stride)
        return fluid.layers.elementwise_add(x=tmp, y=short, act='relu')

    def layer_warp(block_func, input, ch_in, ch_out, count, stride):  # noqa: A002
        tmp = block_func(input, ch_in, ch_out, stride)
        for i in range(1, count):
            tmp = block_func(tmp, ch_out, ch_out, 1)
        return tmp

    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input=input, ch_out=16, filter_size=3, stride=1,
                          padding=1)
    res1 = layer_warp(basicblock, conv1, 16, 16, n, 1)
    res2 = layer_warp(basicblock, res1, 16, 32, n, 2)
    res3 = layer_warp(basicblock, res2, 32, 64, n, 2)
    return fluid.layers.pool2d(input=res3, pool_size=8, pool_type='avg',
                               pool_stride=1)


def image_classification(paddle=None, depth=32, batch_size=32,
                         seed=None, qat=False) -> Book:
    """test_image_classification.py's resnet_cifar10 (the upstream Book's
    depth 32 by default; ``tests/test_book.py`` cuts it to 8). With
    ``qat``, the forward program goes through the package's
    ``slim.quantization.quant_aware`` (its scale variables initialized
    by the startup program) before the optimizer minimizes it, as
    quantization-aware training is set up; the test clone is the float
    forward."""
    paddle = paddle or port_package()
    fluid, main, startup = _programs(paddle, seed)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        images = fluid.layers.data(name='pixel', shape=[3, 32, 32],
                                   dtype='float32')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        net = resnet_cifar10(fluid, images, depth)
        predict = fluid.layers.fc(input=net, size=10, act='softmax')
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        avg_cost = fluid.layers.mean(cost)
        acc = fluid.layers.accuracy(input=predict, label=label)
        test_program = main.clone(for_test=True)
        if qat:
            quant = importlib.import_module(
                f"{paddle.__name__}.slim.quantization")
            main = quant.quant_aware(main, startup)
            avg_cost, acc, predict = (main.global_block().var(v.name) for v
                                      in (avg_cost, acc, predict))
        with fluid.program_guard(main, startup):
            optimizer = fluid.optimizer.Adam(learning_rate=0.001)
            optimizer.minimize(avg_cost)
        train_reader = paddle.batch(
            paddle.reader.shuffle(paddle.dataset.cifar.train10(),
                                  buf_size=512),
            batch_size=batch_size, drop_last=True)
        feeder = fluid.DataFeeder(feed_list=[images, label],
                                  place=fluid.CPUPlace())
    return Book("image_classification", main, startup, test_program,
                avg_cost, [avg_cost, acc], ["pixel"], [predict],
                train_reader, feeder.feed, "adam", 0.001)


SRL_FEEDS = ['word_data', 'ctx_n2_data', 'ctx_n1_data', 'ctx_0_data',
             'ctx_p1_data', 'ctx_p2_data', 'verb_data', 'mark_data']


def label_semantic_roles(paddle=None, word_dim=16, mark_dim=5,
                         hidden_dim=64, depth=4, batch_size=20, maxlen=12,
                         seed=None) -> Book:
    """test_label_semantic_roles.py: db_lstm, the linear-chain CRF and
    Viterbi decoding, with ``exponential_decay``'s lr (the padded form:
    each sequence feed ``[b, maxlen]`` plus one length feed)."""
    paddle = paddle or port_package()
    fluid, main, startup = _programs(paddle, seed)
    word_dict, verb_dict, label_dict = paddle.dataset.conll05.get_dict()
    word_dict_len, label_dict_len = len(word_dict), len(label_dict)
    pred_dict_len, mark_dict_len = len(verb_dict), 2
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds = [fluid.layers.data(name=n, shape=[maxlen], dtype='int64')
                 for n in SRL_FEEDS]
        target = fluid.layers.data(name='target', shape=[maxlen],
                                   dtype='int64')
        seq_len = fluid.layers.data(name='seq_len', shape=[], dtype='int64')
        word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate, mark = feeds
        predicate_embedding = fluid.layers.embedding(
            input=predicate, size=[pred_dict_len, word_dim],
            dtype='float32', param_attr='vemb')
        mark_embedding = fluid.layers.embedding(
            input=mark, size=[mark_dict_len, mark_dim], dtype='float32')
        word_input = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2]
        emb_layers = [
            fluid.layers.embedding(size=[word_dict_len, word_dim], input=x,
                                   param_attr=fluid.ParamAttr(name='emb'))
            for x in word_input]
        emb_layers.append(predicate_embedding)
        emb_layers.append(mark_embedding)
        hidden_0_layers = [
            fluid.layers.fc(input=emb, size=hidden_dim, num_flatten_dims=2)
            for emb in emb_layers]
        hidden_0 = fluid.layers.sums(input=hidden_0_layers)
        lstm_0, _ = fluid.layers.dynamic_lstm(
            input=hidden_0, size=hidden_dim, sequence_length=seq_len,
            candidate_activation='relu', gate_activation='sigmoid',
            cell_activation='sigmoid')
        input_tmp = [hidden_0, lstm_0]
        for i in range(1, depth):
            mix_hidden = fluid.layers.sums(input=[
                fluid.layers.fc(input=input_tmp[0], size=hidden_dim,
                                num_flatten_dims=2),
                fluid.layers.fc(input=input_tmp[1], size=hidden_dim,
                                num_flatten_dims=2)])
            lstm, _ = fluid.layers.dynamic_lstm(
                input=mix_hidden, size=hidden_dim, sequence_length=seq_len,
                candidate_activation='relu', gate_activation='sigmoid',
                cell_activation='sigmoid', is_reverse=((i % 2) == 1))
            input_tmp = [mix_hidden, lstm]
        feature_out = fluid.layers.sums(input=[
            fluid.layers.fc(input=input_tmp[0], size=label_dict_len,
                            num_flatten_dims=2, act='tanh'),
            fluid.layers.fc(input=input_tmp[1], size=label_dict_len,
                            num_flatten_dims=2, act='tanh')])
        transition = fluid.layers.create_parameter(
            shape=[label_dict_len + 2, label_dict_len], dtype='float32',
            name='crfw')
        crf_cost = fluid.layers.linear_chain_crf(
            input=feature_out, label=target, param_attr=transition,
            length=seq_len)
        avg_cost = fluid.layers.mean(crf_cost)
        crf_decode = fluid.layers.crf_decoding(
            input=feature_out, param_attr=transition, length=seq_len)
        test_program = main.clone(for_test=True)
        lr = fluid.layers.exponential_decay(
            learning_rate=0.01, decay_steps=100000, decay_rate=0.5,
            staircase=True)
        sgd_optimizer = fluid.optimizer.SGD(learning_rate=lr)
        sgd_optimizer.minimize(avg_cost)
        train_reader = paddle.batch(
            paddle.reader.shuffle(paddle.dataset.conll05.test(),
                                  buf_size=512),
            batch_size=batch_size, drop_last=True)
        feeder = fluid.DataFeeder(feed_list=feeds + [target, seq_len],
                                  place=fluid.CPUPlace())
    return Book("label_semantic_roles", main, startup, test_program,
                avg_cost, [avg_cost, crf_decode, lr],
                SRL_FEEDS + ['seq_len'], [crf_decode], train_reader,
                feeder.feed, "sgd", 0.01)


def recommender_system(paddle=None, batch_size=128, is_sparse=True,
                       seed=None) -> Book:
    """test_recommender_system.py (the two sequence feeds fixed [4]
    windows with a length feed)."""
    paddle = paddle or port_package()
    fluid, main, startup = _programs(paddle, seed)
    layers, nets, movielens = fluid.layers, fluid.nets, \
        paddle.dataset.movielens
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        def get_usr_combined_features():
            usr_dict_size = movielens.max_user_id() + 1
            uid = layers.data(name='user_id', shape=[1], dtype='int64')
            usr_emb = layers.embedding(
                input=uid, dtype='float32', size=[usr_dict_size, 32],
                param_attr='user_table', is_sparse=is_sparse)
            usr_fc = layers.fc(input=usr_emb, size=32)
            usr_gender_id = layers.data(name='gender_id', shape=[1],
                                        dtype='int64')
            usr_gender_emb = layers.embedding(
                input=usr_gender_id, size=[2, 16],
                param_attr='gender_table', is_sparse=is_sparse)
            usr_gender_fc = layers.fc(input=usr_gender_emb, size=16)
            usr_age_id = layers.data(name='age_id', shape=[1],
                                     dtype="int64")
            usr_age_emb = layers.embedding(
                input=usr_age_id, size=[len(movielens.age_table), 16],
                is_sparse=is_sparse, param_attr='age_table')
            usr_age_fc = layers.fc(input=usr_age_emb, size=16)
            usr_job_id = layers.data(name='job_id', shape=[1],
                                     dtype="int64")
            usr_job_emb = layers.embedding(
                input=usr_job_id, size=[movielens.max_job_id() + 1, 16],
                param_attr='job_table', is_sparse=is_sparse)
            usr_job_fc = layers.fc(input=usr_job_emb, size=16)
            concat_embed = layers.concat(
                input=[usr_fc, usr_gender_fc, usr_age_fc, usr_job_fc],
                axis=-1)
            return layers.fc(input=concat_embed, size=200, act="tanh")

        def get_mov_combined_features(seq4_len):
            mov_id = layers.data(name='movie_id', shape=[1], dtype='int64')
            mov_emb = layers.embedding(
                input=mov_id, dtype='float32',
                size=[movielens.max_movie_id() + 1, 32],
                param_attr='movie_table', is_sparse=is_sparse)
            mov_fc = layers.fc(input=mov_emb, size=32)
            category_id = layers.data(name='category_id', shape=[4],
                                      dtype='int64')
            mov_categories_emb = layers.embedding(
                input=category_id,
                size=[len(movielens.movie_categories()), 32],
                is_sparse=is_sparse)
            mov_categories_hidden = layers.sequence_pool(
                input=mov_categories_emb, pool_type="sum",
                sequence_length=seq4_len)
            mov_title_id = layers.data(name='movie_title', shape=[4],
                                       dtype='int64')
            mov_title_emb = layers.embedding(
                input=mov_title_id,
                size=[len(movielens.get_movie_title_dict()), 32],
                is_sparse=is_sparse)
            mov_title_conv = nets.sequence_conv_pool(
                input=mov_title_emb, num_filters=32, filter_size=3,
                act="tanh", pool_type="sum", sequence_length=seq4_len)
            concat_embed = layers.concat(
                input=[mov_fc, mov_categories_hidden, mov_title_conv],
                axis=-1)
            return layers.fc(input=concat_embed, size=200, act="tanh")

        seq4_len = layers.data(name='seq4_len', shape=[], dtype='int64')
        usr = get_usr_combined_features()
        usr = layers.reshape(usr, [-1, 200])
        mov = get_mov_combined_features(seq4_len)
        inference = layers.cos_sim(X=usr, Y=mov)
        scale_infer = layers.scale(x=inference, scale=5.0)
        label = layers.data(name='score', shape=[1], dtype='float32')
        square_cost = layers.square_error_cost(input=scale_infer,
                                               label=label)
        avg_cost = layers.mean(square_cost)
        test_program = main.clone(for_test=True)
        sgd_optimizer = fluid.optimizer.SGD(learning_rate=0.2)
        sgd_optimizer.minimize(avg_cost)
        train_reader = paddle.batch(
            paddle.reader.shuffle(movielens.train(), buf_size=8192),
            batch_size=batch_size, drop_last=True)

    def feed(data):
        import numpy
        return {
            'user_id': numpy.array([[d[0]] for d in data], 'int64'),
            'gender_id': numpy.array([[d[1]] for d in data], 'int64'),
            'age_id': numpy.array([[d[2]] for d in data], 'int64'),
            'job_id': numpy.array([[d[3]] for d in data], 'int64'),
            'movie_id': numpy.array([[d[4]] for d in data], 'int64'),
            'category_id': numpy.stack([d[5] for d in data]),
            'movie_title': numpy.stack([d[6] for d in data]),
            'seq4_len': numpy.full((len(data),), 4, 'int64'),
            'score': numpy.array([[d[7]] for d in data], 'float32'),
        }

    return Book("recommender_system", main, startup, test_program, avg_cost,
                [avg_cost],
                ['user_id', 'gender_id', 'age_id', 'job_id', 'movie_id',
                 'category_id', 'movie_title', 'seq4_len'],
                [scale_infer], train_reader, feed, "sgd", 0.2)


def rnn_encoder_decoder(paddle=None, dict_size=200, hidden_dim=32,
                        embedding_dim=16, batch_size=16, src_len=8,
                        trg_len=6, seed=None) -> Book:
    """test_rnn_encoder_decoder.py: a bi-LSTM encoder and a DynamicRNN
    decoder (``dict_size`` 30000 is the upstream Book's)."""
    paddle = paddle or port_package()
    fluid, main, startup = _programs(paddle, seed)
    encoder_size = decoder_size = hidden_dim
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        def bi_lstm_encoder(input_seq, hidden_size, seq_len):
            input_forward_proj = fluid.layers.fc(
                input=input_seq, size=hidden_size * 4, num_flatten_dims=2,
                bias_attr=True)
            forward, _ = fluid.layers.dynamic_lstm(
                input=input_forward_proj, size=hidden_size * 4,
                sequence_length=seq_len, use_peepholes=False)
            input_backward_proj = fluid.layers.fc(
                input=input_seq, size=hidden_size * 4, num_flatten_dims=2,
                bias_attr=True)
            backward, _ = fluid.layers.dynamic_lstm(
                input=input_backward_proj, size=hidden_size * 4,
                is_reverse=True, sequence_length=seq_len,
                use_peepholes=False)
            forward_last = fluid.layers.sequence_last_step(
                input=forward, sequence_length=seq_len)
            backward_first = fluid.layers.sequence_first_step(
                input=backward, sequence_length=seq_len)
            return forward_last, backward_first

        def lstm_step(x_t, hidden_t_prev, cell_t_prev, size):
            def linear(inputs):
                return fluid.layers.fc(input=inputs, size=size,
                                       bias_attr=True)

            forget_gate = fluid.layers.sigmoid(linear([hidden_t_prev, x_t]))
            input_gate = fluid.layers.sigmoid(linear([hidden_t_prev, x_t]))
            output_gate = fluid.layers.sigmoid(linear([hidden_t_prev, x_t]))
            cell_tilde = fluid.layers.tanh(linear([hidden_t_prev, x_t]))
            cell_t = fluid.layers.sums(input=[
                fluid.layers.elementwise_mul(x=forget_gate, y=cell_t_prev),
                fluid.layers.elementwise_mul(x=input_gate, y=cell_tilde)])
            hidden_t = fluid.layers.elementwise_mul(
                x=output_gate, y=fluid.layers.tanh(cell_t))
            return hidden_t, cell_t

        def lstm_decoder_without_attention(target_embedding, decoder_boot,
                                           context, size):
            rnn = fluid.layers.DynamicRNN()
            cell_init = fluid.layers.fill_constant_batch_size_like(
                input=decoder_boot, value=0.0, shape=[-1, size],
                dtype='float32')
            cell_init.stop_gradient = False
            with rnn.block():
                current_word = rnn.step_input(target_embedding)
                context_in = rnn.static_input(context)
                hidden_mem = rnn.memory(init=decoder_boot,
                                        need_reorder=True)
                cell_mem = rnn.memory(init=cell_init)
                decoder_inputs = fluid.layers.concat(
                    input=[context_in, current_word], axis=1)
                h, c = lstm_step(decoder_inputs, hidden_mem, cell_mem, size)
                rnn.update_memory(hidden_mem, h)
                rnn.update_memory(cell_mem, c)
                out = fluid.layers.fc(input=h, size=dict_size,
                                      bias_attr=True, act='softmax')
                rnn.output(out)
            return rnn()

        src_word_idx = fluid.layers.data(name='source_sequence',
                                         shape=[src_len], dtype='int64')
        src_length = fluid.layers.data(name='src_len', shape=[],
                                       dtype='int64')
        src_embedding = fluid.layers.embedding(
            input=src_word_idx, size=[dict_size, embedding_dim],
            dtype='float32')
        src_forward_last, src_backward_first = bi_lstm_encoder(
            src_embedding, encoder_size, src_length)
        encoded_vector = fluid.layers.concat(
            input=[src_forward_last, src_backward_first], axis=1)
        decoder_boot = fluid.layers.fc(input=src_backward_first,
                                       size=decoder_size, bias_attr=False,
                                       act='tanh')
        trg_word_idx = fluid.layers.data(name='target_sequence',
                                         shape=[trg_len], dtype='int64')
        trg_embedding = fluid.layers.embedding(
            input=trg_word_idx, size=[dict_size, embedding_dim],
            dtype='float32')
        prediction = lstm_decoder_without_attention(
            trg_embedding, decoder_boot, encoded_vector, decoder_size)
        label = fluid.layers.data(name='label_sequence', shape=[trg_len],
                                  dtype='int64')
        flat_pred = fluid.layers.reshape(prediction, [-1, dict_size])
        flat_label = fluid.layers.reshape(label, [-1, 1])
        cost = fluid.layers.cross_entropy(input=flat_pred, label=flat_label)
        avg_cost = fluid.layers.mean(cost)
        test_program = main.clone(for_test=True)
        optimizer = fluid.optimizer.Adagrad(learning_rate=0.05)
        optimizer.minimize(avg_cost)
        train_reader = paddle.batch(
            paddle.reader.shuffle(paddle.dataset.wmt14.train(dict_size),
                                  buf_size=1000),
            batch_size=batch_size, drop_last=True)

    def feed(data):
        import numpy
        return {'source_sequence': numpy.stack([d[0] for d in data]),
                'src_len': numpy.full((len(data),), src_len, 'int64'),
                'target_sequence': numpy.stack([d[1] for d in data]),
                'label_sequence': numpy.stack([d[2] for d in data])}

    return Book("rnn_encoder_decoder", main, startup, test_program,
                avg_cost, [avg_cost],
                ['source_sequence', 'src_len', 'target_sequence'],
                [prediction], train_reader, feed, "adagrad", 0.05)


def machine_translation(paddle=None, dict_size=200, hidden_dim=32,
                        word_dim=16, batch_size=16, is_sparse=True,
                        src_len=8, trg_len=6, seed=None) -> Book:
    """test_machine_translation.py's train_main: an LSTM encoder, a
    DynamicRNN decoder and Adagrad with L2 regularization."""
    paddle = paddle or port_package()
    fluid, main, startup = _programs(paddle, seed)
    pd = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        def encoder():
            src_word_id = pd.data(name="src_word_id", shape=[src_len],
                                  dtype='int64')
            src_length = pd.data(name="src_len", shape=[], dtype='int64')
            src_embedding = pd.embedding(
                input=src_word_id, size=[dict_size, word_dim],
                dtype='float32', is_sparse=is_sparse,
                param_attr=fluid.ParamAttr(name='vemb'))
            fc1 = pd.fc(input=src_embedding, size=hidden_dim * 4,
                        num_flatten_dims=2, act='tanh')
            lstm_hidden0, lstm_0 = pd.dynamic_lstm(
                input=fc1, size=hidden_dim * 4, sequence_length=src_length)
            return pd.sequence_last_step(input=lstm_hidden0,
                                         sequence_length=src_length)

        def decoder_train(context):
            trg_language_word = pd.data(name="target_language_word",
                                        shape=[trg_len], dtype='int64')
            trg_embedding = pd.embedding(
                input=trg_language_word, size=[dict_size, word_dim],
                dtype='float32', is_sparse=is_sparse,
                param_attr=fluid.ParamAttr(name='vemb'))
            rnn = pd.DynamicRNN()
            with rnn.block():
                current_word = rnn.step_input(trg_embedding)
                pre_state = rnn.memory(init=context)
                current_state = pd.fc(input=[current_word, pre_state],
                                      size=hidden_dim, act='tanh')
                current_score = pd.fc(input=current_state, size=dict_size,
                                      act='softmax')
                rnn.update_memory(pre_state, current_state)
                rnn.output(current_score)
            return rnn()

        context = encoder()
        rnn_out = decoder_train(context)
        label = pd.data(name="target_language_next_word", shape=[trg_len],
                        dtype='int64')
        cost = pd.cross_entropy(input=pd.reshape(rnn_out, [-1, dict_size]),
                                label=pd.reshape(label, [-1, 1]))
        avg_cost = pd.mean(cost)
        test_program = main.clone(for_test=True)
        optimizer = fluid.optimizer.Adagrad(
            learning_rate=0.05,
            regularization=fluid.regularizer.L2DecayRegularizer(
                regularization_coeff=1e-4))
        optimizer.minimize(avg_cost)
        train_reader = paddle.batch(
            paddle.reader.shuffle(paddle.dataset.wmt14.train(dict_size),
                                  buf_size=1000),
            batch_size=batch_size, drop_last=True)

    def feed(data):
        import numpy
        return {'src_word_id': numpy.stack([d[0] for d in data]),
                'src_len': numpy.full((len(data),), src_len, 'int64'),
                'target_language_word': numpy.stack([d[1] for d in data]),
                'target_language_next_word': numpy.stack(
                    [d[2] for d in data])}

    return Book("machine_translation", main, startup, test_program,
                avg_cost, [avg_cost],
                ['src_word_id', 'src_len', 'target_language_word'],
                [rnn_out], train_reader, feed, "adagrad", 0.05)


#: the Book's programs in ``tests/test_book.py``'s order
PROGRAMS = {"fit_a_line": fit_a_line, "recognize_digits": recognize_digits,
            "word2vec": word2vec,
            "image_classification": image_classification,
            "label_semantic_roles": label_semantic_roles,
            "recommender_system": recommender_system,
            "rnn_encoder_decoder": rnn_encoder_decoder,
            "machine_translation": machine_translation}


def ctc_tagger(paddle=None, batch_size=8, max_t=16, max_label=6,
               feat_dim=24, hidden=64, num_classes=12, future_context=2,
               seed=None) -> Book:
    """A small CTC tagger (a DeepSpeech-style lookahead over packed
    frames), built only from sequence builders the Book does not
    reach: the packed frames ``sequence_pad`` to ``[b, max_t, d]``,
    an ``fc`` and ``row_conv`` lookahead, per-frame class scores,
    ``warpctc`` against padded labels, SGD; ``ctc_greedy_decoder`` and
    ``edit_distance`` against the labels, and ``sequence_unpad`` of the
    scores. Its reader draws seeded rows of random lengths."""
    import numpy as np
    paddle = paddle or port_package()
    fluid, main, startup = _programs(paddle, seed)
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        frames = L.data(name='frames', shape=[batch_size * max_t, feat_dim],
                        dtype='float32', append_batch_size=False)
        frame_len = L.data(name='frame_len', shape=[batch_size],
                           dtype='int64', append_batch_size=False)
        label = L.data(name='label', shape=[batch_size, max_label],
                       dtype='int64', append_batch_size=False)
        label_len = L.data(name='label_len', shape=[batch_size],
                           dtype='int64', append_batch_size=False)
        pad = L.fill_constant(shape=[1], dtype='float32', value=0.0)
        padded, lengths = L.sequence_pad(frames, pad, frame_len, max_t)
        padded.shape = (batch_size, max_t, feat_dim)
        hid = L.fc(input=padded, size=hidden, num_flatten_dims=2,
                   act='relu')
        hid.shape = (batch_size, max_t, hidden)
        look = L.row_conv(hid, future_context_size=future_context,
                          act='relu')
        look.shape = (batch_size, max_t, hidden)
        scores = L.fc(input=look, size=num_classes, num_flatten_dims=2)
        scores.shape = (batch_size, max_t, num_classes)
        ctc = L.warpctc(input=scores, label=label, blank=0,
                        input_length=lengths, label_length=label_len)
        avg_cost = L.mean(ctc)
        decoded, dec_len = L.ctc_greedy_decoder(scores, blank=0)
        dist, _ = L.edit_distance(decoded, label, normalized=False,
                                  input_length=dec_len,
                                  label_length=label_len)
        packed, total = L.sequence_unpad(scores, lengths)
        test_program = main.clone(for_test=True)
        fluid.optimizer.SGD(learning_rate=0.05).minimize(avg_cost)

    def reader():
        rng = np.random.RandomState(11)
        while True:
            t_len = rng.randint(max_t // 2, max_t + 1, batch_size)
            l_len = rng.randint(1, max_label + 1, batch_size)
            lab = np.zeros((batch_size, max_label), np.int64)
            for i, n in enumerate(l_len):
                lab[i, :n] = rng.randint(1, num_classes, n)
            x = np.zeros((batch_size * max_t, feat_dim), np.float32)
            x[:int(t_len.sum())] = rng.randn(int(t_len.sum()), feat_dim)
            yield [{'frames': x, 'frame_len': t_len.astype(np.int64),
                    'label': lab, 'label_len': l_len.astype(np.int64)}]

    return Book("ctc_tagger", main, startup, test_program, avg_cost,
                [avg_cost, decoded, dec_len, dist, packed, total],
                ['frames', 'frame_len'], [decoded, dec_len], reader,
                lambda data: data[0], "sgd", 0.05)
