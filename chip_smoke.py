#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases:
  1. device  -- the card's name and power limit; TF32 off for matmuls and
                convolutions, so the card computes in full float32 (P4's
                float32 forward keeps f32's digits by three tf32 passes
                of its own, whatever these flags say).
  2. build   -- compiles every kernel under deepchem_tpu_torch/csrc/, one
                nvcc for each source, all at once, and prints ptxas's
                report; ptxas must have serialised no wgmma (info C7512),
                and K1-K4's and P2's kernels must spill nothing.
  3. kernel  -- each kernel against its plain PyTorch version on the card:
                P1 csr_segment_softmax and P3 csr_segment_sum on the inputs
                the model hands them, P2 fused_gather_segment_sum at the
                shapes of scripts/bench_pallas_csr.py, plus wide and edge
                cases and, for P1 and P3, segments long enough to be split
                across a block (up to 40 000 edges); K1 nei_sum, K2
                nei_max (forward with its winners, and backward) and K3
                graph_max_pool (forward and backward) on the inputs
                GraphConvModel hands them in phase 11's first batch of
                256, and on a graph with degrees 0 to 10 (F 1 to 128; K1
                and K2 also at F 4 and at F 64 off 16-byte alignment), tied
                and all-tie maxima, and empty graphs with a ghost tail;
                K1 also from MPNN's edge rows into its nodes, through the
                incoming-edge table (nei_sum_edges) and the outgoing one
                (take_src's backward) of phase 12's first batch, and P1
                and P3 at that batch's set2set readout; K1 at GCN's F 30
                and 64 and from DMPNN's [4096, 300] edge rows, and K4
                nei_gather (forward, and its backward on K1 through the
                reverse-slot rows) at GAT's C 8 and 64 and AttentiveFP's
                C 200, at the inputs phase 13's and 14's first batch of
                100 hands them, with the library call (index_select times
                the mask, and its autograd backward);
                every path of the two-path kernels (float4 rows, one float
                a lane; K3's backward and K4 too) launched.  Then K1-K3 at
                values the model never hands them (NaN, infinities,
                signed zeros, values at and below NEG; K1 also from 2400
                edge rows into 1000 nodes), each path, held
                for exact equality with the plain versions, NaN where NaN
                and signs of zeros equal, and P1 at +inf, NaN, -inf and
                overflowing logits on each of its paths, NaN where the
                plain version gives NaN; K4 forward and backward at C 1,
                8, 64, 200 and 75 and off alignment, and K1 at F 30 and
                300, at NaN, infinities and signed zeros, held the same
                way.  P2 in bfloat16 at the same bench shapes, at F 37,
                off 16-byte alignment, on the two long segments (a hub
                of 2000 edges at F 64, 4096 edge rows at F 300) and at
                NaN, infinities, subnormals, signed zeros and sums that
                overflow, bit for bit against its plain version (NaN
                bits too) and the same on a repeat (the float64 sums of
                the same inputs recorded), with index_select and
                index_add_ in bfloat16 as the library call, its bounds
                (bytes, the launch floor at its grid and its first
                design's, and the order chain: the longest segment times
                one dependent add, timed on the card), and its own path:
                one call per bench shape;
                P2 (float32) at the inputs phase 16's first batch of 100
                hands it (GNNModular's GCN layers at F 30 and 64 and their
                backward's transpose, PNA's [E, 64] edge sums) and K3 at
                PNA's max over each node's edges; and at the inputs phase
                17's first batches hand them: P2 at GraphConv's COO
                neighbour sum (F 75, batch 256, the ghost edges' long last
                segment) and its neighbour max's source gather backward,
                K3 at that neighbour max, P1 at GAT's [E, 8] edge logits
                and P2 at DMPNN's [E, 300] edge sums (batch 100); P2
                also on a hub node's 2000 in-edges (F 64) and on one
                segment of 4096 edge rows (F 300), each split across its
                block; and at the inputs phase 19's first DAG batch of
                100 hands them: P2 at a level pass's [E, 30] message sum
                and at its source gather's backward, P3 at the readout;
                and at the inputs phase 20's first batch of 32 crystals
                hands them: P2 at CGCNN's [E, 64] edge sum (E = 12 N) and
                at its gathers' backward, P3 at CGCNN's mean readout,
                MEGNet's graph mean of h and its edges' sum into their
                graphs (over the nodes' sums), and at InfoMax3D
                pretraining's first batch of 32 conformer graphs: P2 at
                the 3D encoder's [E, 64] edge sum, K3 (both ways) at the
                2D encoder's max over each atom's edges.
                Per case:
                max abs error, a bit-identical repeat, kernel, plain and
                library times (host-clock ms a call), the kernel's device
                µs a launch and the library call's device µs (profiler;
                for P2 also the library's over the kernel's), bound.
                Then P1's backward against autograd through its plain
                version, and P2's own path: one call per bench shape, its
                launches counted.
  4. serve   -- PagtnModel(n_tasks=12, mode='classification') at its
                default widths, seeded random weights, answers requests of
                1, 16 and 31 molecules with predict_on_batch; the outputs
                are checked and held against the same model on the CPU, and
                P1's and P3's launches are read (P3 once a layer and once
                for the sum readout).
  5. train   -- the same model with dropout 0.1 fits the 48 molecules with
                seeded 0/1 labels for 4 epochs (12 steps of 16); losses,
                step-1 gradients and launches are checked.  A dropout-free
                copy is held against the CPU, and a fixed batch must
                overfit.
  6. flash   -- P4's three kernels (flash_attention_fwd, _dkv, _dq) against
                the plain flash attention on the card: at the encoder's
                shape [32, 12, 128, 64] in bfloat16 and float32, at
                scripts/attn_crossover.py's shapes (H 12, D 64, 65 536
                tokens, S 128 to 4096) in bfloat16, and at S 200, D 32;
                in float32 also at S 512 and 4096.
                Per case and kernel: max abs error (and the forward's m
                and l row by row; in bfloat16 also against the output's
                own max |ref|; in float32 o, dK, dV and dQ and the plain
                version's, recorded against the plain version in
                float64), a bit-identical repeat, kernel, plain
                and library (SDPA) times, device µs a launch, bound; the
                device µs of whole calls of SDPA's forward, SDPA's
                backward and the port's backward (di, dK/dV and dQ).  Then
                P4's own path: forward and backward once per crossover
                shape, its launches counted.
  7. encoder -- BertEncoderMLM at the ChemBERTa-77M-class width (vocab 600,
                hidden 768, 12 layers, 12 heads, intermediate 3072),
                seeded random weights, float32, answers requests of 1, 16
                and 31 SMILES tokenized by SmilesTokenizer.from_corpus and
                padded to 128 with an attention mask (the einsum route);
                logits held against a CPU run of the same weights.
  8. encoder through P4 -- the module's attention swapped for the flash
                route (as scripts/mfu_ablation.py swaps it in JAX), no
                mask: a forward and one training step held against the
                einsum route on the card, 10 AdamW steps at lr 1e-4,
                batch 16, in bfloat16 and in float32, each with 12
                launches of each P4 kernel a step, and a fixed batch that
                must overfit.
  9. encoder gradients -- the einsum route in float32, card against CPU:
                every parameter's step-1 gradient.
 11. graphconv -- GraphConvModel at bench.py's width (layers 64 and 64,
                dense 128, batch 256, lr 0.002, 12 tasks), seeded random
                weights, on the 48 SMILES repeated and shuffled to 768
                with seeded 0/1 labels: predict_on_batch answers requests
                of 1, 16 and 31 (held against the CPU), predict_on_device
                scores the 768, 30 requests of 16 are timed (median,
                p90); fit_on_device trains 3 epochs (the step time over the
                last 2; K1-K3 and P3 launches a step counted), step-1
                gradients are held against the CPU, a fixed batch must
                overfit, and evaluate's ROC-AUC is held against the CPU.
 12. mpnn    -- MPNNModel(n_tasks=1) at the JAX package's defaults (30
                atom and 11 bond features, T 3, M 6, node_dim 64, batch
                100, regression), seeded random weights, on the 48 SMILES
                and 6 with cis/trans marks shuffled to 300, seeded labels
                normalised by NormalizationTransformer: predict_on_batch
                answers requests of 1, 16 and 31 (held against the CPU),
                predict scores the 300 (held against the CPU), 100
                requests of 16 are timed (median, p90); fit trains 3
                epochs (the step time over the last 2; K1, P1 and P3
                launches a step counted: K1 T forward in nei_sum_edges and
                T backward in take_src, P1 M, P3 2 M), step-1 gradients
                are held against the CPU, a fixed batch must overfit, and
                evaluate's pearson r2, RMS and MAE through the transformer
                are held against the CPU.
 13. gnn     -- GCNModel (layers 64, 64), GATModel (layers 8, 8 of 8
                heads) and AttentiveFPModel (2 layers of 200) at the JAX
                package's defaults (batch 100, predictor 128, one
                regression task), seeded random weights, on the 48 SMILES
                featurized by MolGraphConvFeaturizer and shuffled to 300
                with seeded normal labels, each: predict_on_batch answers
                requests of 1, 16 and 31 and predict scores the 300 (held
                against the CPU), 30 requests of 16 are timed (median,
                p90); fit and fit_on_device train 3 epochs each (the step
                time over the last 2; fit_on_device's per-epoch losses
                against the CPU's; launches a batch and a step counted:
                GCN K1 2 forward + 1 backward, GAT and AttentiveFP K4 4
                forward + K1 4 in its backward, P3 2 for the mean
                readout or 1 for the sum),
                step-1 gradients are held against the CPU, a fixed batch
                must overfit, evaluate's pearson r2, RMS and MAE are held
                against the CPU, and the card's busy µs and kernels of a
                request of 16 and of a step are read.
 14. dmpnn   -- DMPNNModel at the JAX package's defaults (133 atom and 14
                bond features, hidden 300, depth 3, FFN 300 x 3, batch
                100, one regression task) on the 48 SMILES and 6 with
                cis/trans marks featurized by DMPNNFeaturizer, shuffled to
                300, as phase 13 (K1 3 a forward in nei_sum_edges, none in
                its backward, a gather; P3 1).
 15. engine  -- the training engine on GraphConvModel at bench.py's width
                over the 48 SMILES repeated and shuffled to 7680 (30
                batches of 256) with seeded 0/1 labels: step 1 under
                ExponentialDecay(0.002, 0.9, 10) held against the CPU
                (1e-5); fit for 2 epochs with a ValidationCallback every 10
                steps (the rate of each step, equal to the schedule's, and
                each validation line printed), the best checkpoint restored
                and scored to the logged best score; evaluate_on_device's
                ROC-AUC, PRC-AUC and accuracy within 1e-12 of evaluate's;
                reinitialize(seed=3) bit for bit a fresh seed-3 model, and a
                fit_on_device epoch after it timed against a fresh model's
                first; fit_on_device for 2 epochs streamed in chunks of 5
                batches past device_data_budget against the resident run
                from the same weights and seed: per-epoch losses and
                parameters bit for bit, the same launches, the peak memory
                within 1.1 times 2 chunks plus the resident run's working
                set, host ms a step of both (streamed, resident, streamed,
                resident); a regressor with
                uncertainty=True and dropout 0.2 gives
                predict_uncertainty(masks=50) over 768 molecules through the
                kernels and through the plain versions from the same dropout
                seeds, within 1e-5 of max(1, |ref|), standard deviations
                finite and positive.  K1-K3 and P3 must launch.
 16. coo     -- PNAModel (hidden 64, 3 layers, mean, max, min and std
                under identity, amplification and attenuation),
                GNNModular (emb_dim 64, 3 GCN layers) as a regressor and
                on edge prediction, and InfoGraphStarModel (embedding 64,
                3 layers) at the JAX package's defaults (batch 100, one
                regression task), seeded random weights, on phase 13's
                300 molecules, each: requests of 1, 16 and 31 and the
                whole set answered (predictions, or edge_pred's per-edge
                scores) and held against the CPU, 30 requests of 16
                timed (median, p90); fit and fit_on_device train 3 epochs
                each (the step time over the last 2; fit_on_device's
                per-epoch losses against the CPU's; launches a batch and
                a step counted: P2 once a GCN layer and its transpose in
                the backward of layers 2 and 3, PNA P2 2 and K3 2 a layer
                and K3's backward, P3 for the readouts), step-1 gradients
                against the CPU, a fixed batch that must overfit, and
                evaluate's pearson r2, RMS and MAE (edge_pred: loss_func
                on a batch) against the CPU; the card's busy µs and
                kernels of a request of 16 and of a step.
 17. coo branches -- GraphConvModel at bench.py's width (phase 11's
                model and molecules, 12 classification tasks), GCN, GAT,
                AttentiveFP, MPNN (T 3, M 6) and DMPNN at the JAX
                package's defaults (phase 13's, 12's and 14's models and
                molecules), each with its class switched to the COO
                branch (uses_neighbor_table and uses_rev_slot, or
                uses_edge_table, set to False, as the JAX package's tests
                switch them): its predictions over the whole set held
                against its table path on the card from the same weights
                (rtol 1e-4, atol 1e-5), then as phase 13 through
                model_phase (ROC-AUC for GraphConv), with the launches of
                P1, P2, P2's transpose, P3 and K3 forward and backward a
                batch and a step asserted.
 18. dense  -- the fingerprint models on CircularFingerprint(size=1024)
                of the 48 SMILES repeated and shuffled to 768 (featurize
                ms a molecule), seeded labels for 12 tasks, at
                molnet/run_benchmark.py's presets: tf (MultitaskClassifier
                [1500], dropout 0.5, l2 penalty 0.1, batch 50), tf_robust
                ([500], bypass [100]), tf_regression ([1000, 1000],
                dropout 0.25, batch 128), ProgressiveMultitaskClassifier,
                MultitaskIRVClassifier (K 10, through IRVTransformer),
                ScScoreModel (on pairs) and SingletaskToMultitask over
                three MultitaskRegressors, each: requests of 16 against
                the CPU and 30 timed (median, p90), 3 fit epochs (the
                step time over the last 2), and its scores (ROC-AUC, RMS,
                ScScore's hinge loss) over each SMILES's first copy
                against the CPU from the same weights.  These models run
                no kernel of their own.
 19. weave, dag, dtnn -- WeaveModel at molnet/run_benchmark.py's
                'weave' preset (12 classification tasks, n_graph_feat
                128, n_hidden 50, 2 weave layers, batch 64, lr 0.0005) on
                WeaveFeaturizer of phase 11's 768 molecules (batches of A
                32 and 48: fit_on_device must refuse them, as the JAX
                package's does, and trains on the 752 of at most 32
                atoms; ROC-AUC over each SMILES's first copy); DAGModel at
                the JAX package's defaults (max_atoms 50, n_graph_feat 30,
                12 level passes, batch 100, one regression task) on
                ConvMolFeaturizer + DAGTransformer of phase 13's 300
                molecules, P2 12 a batch, 12 more in a step's backward,
                P3 1; DTNNModel at its defaults (n_embedding 30, n_hidden
                100, 2 steps, 100 distances, batch 100) on
                CoulombMatrix(max_atoms=23) of the SMILES of at most 23
                atoms embedded by ConformerGenerator(seed=0), repeated
                to 300; MultitaskFitTransformRegressor ([1000], dropout
                0) on CoulombFitTransformer of the same matrices.  Each
                as phase 13 through model_phase, with the card's peak
                memory; Weave, DTNN and the regressor launch no kernel of
                the port's.
 20. materials, infomax3d -- ten prototype crystals (rock salt NaCl and
                MgO, CsCl, diamond Si, zinc-blende GaAs, fcc Cu, bcc Fe,
                cubic SrTiO3, rutile TiO2, wurtzite ZnO) and their 2x2x2
                supercells (2 to 64 atoms) written as structure dicts,
                repeated to 320 with seeded labels (one a structure):
                CGCNNModel (64 wide, 3
                convolutions, head 128, batch 32) on CGCNNFeaturizer()
                (radius 8, 12 neighbours: 12 edges an atom), LCNNModel on
                LCNNFeaturizer(), MEGNetModel (dim 32, 1 block) on
                CGCNNFeaturizer(), ElemNetModel on ElemNetFeaturizer of
                their formulas (dropout 0; then 0.2, the JAX module's, in
                training only), MultitaskRegressor ([1000], dropout 0,
                batch 100) on SineCoulombMatrix() and on
                ElementPropertyFingerprint(), z-scored; then
                InfoMax3DModular (hidden 64, 3 layers, batch 32) on
                RDKitConformerFeaturizer of the 48 SMILES shuffled to 320:
                pretraining (its 2D and 3D embeddings answered, loss_func
                scored), and a regressor loaded by load_from_pretrained
                from a model pretrained on the CPU (the same weights on
                every run).  Each as phase 13 through
                model_phase, CGCNN's and LCNN's answers within 1e-4 of
                max(1, |ref|) and scores within 1e-5 of max(1, |score|)
                (CGCNN answers up to 74 at its initial weights; float32
                alone moves its answers there by 1.27e-4 and its trained
                MAE by 1.08e-6: scripts/materials_float32_drift.py), LCNN
                and
                MEGNet scored by RMS and MAE (their pearson r2 is
                ill-conditioned there), MEGNet's fixed batch given 100
                steps, ElemNet's and InfoMax3D pretraining's
                fit_on_device losses held to the CPU's over their first
                2 and 1 epochs (a 1e-7 change of the weights moves their
                third by up to 4.9e-4 and 3.4e-4), the launches a batch and a step
                asserted: CGCNN P2 3 + 6 in the backward, P3 2; LCNN P2 2
                + 4, P3 2; MEGNet P2 1 + 2, P3 5; InfoMax3D pretraining P2
                9 + 15, K3 6 + 6, P3 3; its regressor P2 6 + 9, K3 6 + 6,
                P3 2.  MEGNet and InfoMax3D (both tasks) also fit twice
                from one seed, 2 steps each: every gradient and weight the
                same bits (as PNA and GNNModular's edge prediction in phase
                16, DMPNN in 14, MPNN in 12 and on its COO branch in 17,
                DTNN in 19: the gathers whose backward was index_add_ with
                float atomics have a fixed-order one).
 21. mxmnet, atomic conv, few-shot, egnn -- MXMNetModel at the JAX
                package's defaults (dim 64, 3 layers, batch 32) on
                MXMNetFeaturizer() of the 48 SMILES in 3D, shuffled to 320
                with seeded labels; AtomicConvModel at its defaults
                (fragments of 70, 634 and 701 atoms, 12 neighbours, batch
                24) on 72 complexes the script writes as PDB text from
                seeded coordinates (a ligand of 40-70 heavy atoms in a
                pocket of 560-630), through AtomicConvFeaturizer(): each
                through model_phase, with the same-bits check; MXMNet's
                launches a batch P2 6, P3 1, a step P2 6 + 12, P3 1;
                AtomicConv's none (its radial product is a batched GEMM).
                SupportGraphClassifier (siamese, attn, res) at the JAX
                package's defaults (n_pos 1, n_neg 9, n_test 16, n_feat 64,
                layers 64 and 64, depth 3) on the 48 SMILES shuffled to
                192 with seeded labels for 4 tasks: requests of 1, 16 and
                31 on a support set against the CPU, 30 timed requests of
                16, 3 epochs of 16 episodes against the CPU's losses,
                launches a request and an episode (P2 2 and P3 2 an
                encoding, P2 1 more in an episode's backward each), step-1
                gradients, a fixed episode that overfits, two runs of 2
                episodes from one seed the same bits, evaluate's ROC-AUC
                against the CPU.  EGNNLayer (hidden 64, coordinates
                updated, binned edge lengths as edge inputs) on 32
                EquivariantGraphFeaturizer graphs: outputs and every
                gradient against the CPU, P2 3 forward + 4 in the
                backward, the same bits on a repeat.
 22. grover, mat -- first the kernels at the shapes of GroverModel's
                flat batch of 256 (below) against their plain versions
                with their bounds and library calls: K1 (the grouped atom
                sum [24 N, 1024] through its offset table, the grouped
                bond sum from [24 E, 1024], the K = 9 to-bond sum), P2 in
                the gathers' backward (the grouped b2a and b2revb gathers,
                the bonds' destinations, the two to-bond slot sums) and
                P3 in the atom and bond readouts.  Then GroverModel at
                scripts/bench_grover_mfu.py:177's 'large' (hidden 1024, 8
                heads, 2 MT blocks, depth 3, batch 256), seeded random
                weights, on GroverFeaturizer of the 48
                SMILES (both vocabularies built over them) shuffled to 768
                with seeded 0/1 labels for 12 tasks: pretraining and
                finetuning (12 classification tasks, ROC-AUC over each
                SMILES's first copy), each in the flat and the packed
                layout, through model_phase: requests of 1, 16 and 31
                and the first 32 of the whole set against a CPU model of
                batch 32 (the CPU follows GROVER-large on small inputs;
                a packed request packs a block a molecule), 30 timed
                requests of 16, 2 fit and 2 fit_on_device epochs at batch
                256 on the card (the step time over the second) with the
                launches a batch and a step asserted (flat: K1 in the
                four custom-VJP sums, 3 nei_sum_sym, 2 nei_sum_sym_g, 3
                nei_sum_bonds, 2 nei_sum_bonds_g a batch, and
                pretraining's 2 to-bond slot sums; a step adds the
                symmetric sums' backward, 3 + 2, and the MPN's forward
                again for each remat level, 'both' at this size: + 4 and
                + 4 of each pair; P2 in the gathers' backward, 8 a step,
                14 pretraining; P3 3 a batch, 6 pretraining; packed: none
                of the port's kernels), 2 steps at batch 8 by fit on both
                devices and fit_on_device on the card against the CPU's
                losses, the card's step-1 gradients of those fits against
                the CPU's (float32 both) within 5e-3 of max(1, |g|)
                (float32 alone puts each up to 2.23e-3 from float64 at
                this width, scripts/grover_float32_drift.py; the faults
                planted by scripts/grover_grad_controls.py move them by
                more), evaluate's ROC-AUC against the CPU's from the
                trained weights (the share of pairs the probabilities'
                difference can swap allowed, that difference within
                1e-4 and the share within 1e-3), two fits of 2 steps at
                batch 256 the same bits, the card's peak memory; models
                after the first of a task and seed are built on the meta
                device and load its weights; flat pretraining's step-1
                gradients at batch 256 under remat 'both' against 'qkv'
                (the level of the checks at batch 8) within 1e-5 of
                max(1, |g|); then MATModel at the published MAT width
                (dim 1024, 8 layers, 16 heads, lambda 0.33 each, batch
                32, 12 classification tasks) on MATFeaturizer of the 48
                SMILES shuffled to 192, through model_phase as GROVER (3
                epochs, a fixed batch of 8 that overfits, no kernel of
                the port's), with the same-bits check and its step-1
                gradients within 1e-5 of the CPU's.
 23. sequence and image models -- at the JAX package's default widths,
                each through model_phase as phase 22's models (requests
                of 1, 16 and 31 against the CPU, fit and fit_on_device
                losses and step-1 gradients against the CPU, two fits of
                2 steps the same bits, a fixed batch that overfits, the
                score against the CPU, the card's busy time and the
                three device ops that take most of a step), the host
                following on small inputs (cpu_cut) where it cannot at
                full size (cuDNN convolutions and GRUs in float32 with
                deterministic algorithms, cuBLAS GEMMs; of the port's
                kernels only P2, once a step in TextCNN's and Smiles2Vec's
                backward: their embeddings' gradient, in a fixed order):
                TextCNNModel (Kim-style filters 1-20, dropout 0.25,
                classification, ROC-AUC) on
                the 48 SMILES shuffled to 300, batch 100; Smiles2Vec
                (embedding 50, conv 192, BiGRUs 224 and 384) on
                SmilesToSeq's 270 tokens; ChemCeption (16 base filters) on
                80 x 80 SmilesToImage images (both regression, RMS and
                MAE); the Aspuru-Guzik autoencoder (512 wide, 4 + 4 GRU
                layers, max_output_length 120; scored by its loss on a
                batch); CNN (dims 1, 100 filters of 5, dense 1000,
                dropout 0.5) on OneHotFeaturizer's [100, 35]; UNet
                (widths 64-512) on 48 disc images of 256 x 256 x 3 with
                their masks, batch 8 (scored by mean BCE and soft dice);
                InceptionV3 on 299 x 299 x 3, batch 16 (its step-1
                gradients within 5e-5 of max(1, |g|): float32 alone puts
                the card's 1.32e-5 from float64,
                scripts/image_float32_drift.py); OneFormer (hidden
                128, 32 queries, 4 decoder layers, 2 labels) on 512 x 512
                x 3, batch 2 (its masks and class logits held against the
                CPU, scored by its loss on a batch), then its
                full-resolution label maps against the CPU's.
 24. molnet  -- bench.py's main path through the port's own entry
                points: a Tox21-shaped tox21.csv.gz written in a temporary
                data dir (the 48 SMILES cycled to Tox21's 8014 rows, 3
                rows that do not parse, seeded 0/1 labels with a fifth of
                the cells empty and some 'NA'), loaded with
                load_tox21(featurizer='graphconv', splitter='random',
                splitter_seed=123) into DiskDatasets (12 tasks, splits of
                6411/801/802 as bench.py's, w 0 exactly at the empty and
                NA cells, balancing weights within 1e-12 of the
                transformer recomputed on train's arrays), reloaded from
                its cache bit for bit, run again step by step for the
                seconds of reading, featurizing, writing shards,
                splitting and transforming; GraphConvModel at bench.py's
                width trained 3 epochs with fit_on_device from the train
                DiskDataset (launches a step as phase 11, epoch losses and
                weights bit for bit a NumpyDataset's run of the same
                arrays; fit's step-1 gradients within 1e-5 of the CPU's,
                its first 12 losses and the 3 epochs' printed beside the
                CPU's), evaluate's
                valid ROC-AUC through the loader's transformers against
                the CPU (1e-6); a ScaffoldSplitter split of the whole set,
                one run_benchmark row (fit_on_device and
                evaluate_on_device, 2 epochs at bench.py's width) and a
                GridHyperparamOpt over two learning rates at 1 epoch.
 25. kernels -- the script's wall, then one JSON line with each kernel's
                numbers (K1, P2 and P3 on GROVER's paths: their launches
                in each phase 22 run, their shapes).
The last line is the JSON device record.  Any failed check exits non-zero.
"""

import contextlib
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent

# 48 drug-like and Tox21-like molecules, 9 to 33 heavy atoms
SMILES = [
    'CC(=O)Oc1ccccc1C(=O)O', 'CN1C=NC2=C1C(=O)N(C(=O)N2C)C',
    'CC(C)Cc1ccc(cc1)C(C)C(=O)O', 'CC(=O)Nc1ccc(O)cc1',
    'COc1ccc2cc(ccc2c1)C(C)C(=O)O', 'OC(=O)Cc1ccccc1Nc1c(Cl)cccc1Cl',
    'CN1C(=O)CN=C(c2ccccc2)c2cc(Cl)ccc21', 'CN1CCCC1c1cccnc1',
    'CN(C)C(=N)NC(=N)N', 'CC(=O)CC(c1ccccc1)c1c(O)c2ccccc2oc1=O',
    'CC12CCC3C(CCC4=CC(=O)CCC34C)C1CCC2O',
    'CC12CCC3c4ccc(O)cc4CCC3C1CCC2O', 'CC(C)(c1ccc(O)cc1)c1ccc(O)cc1',
    'Oc1cc(Cl)ccc1Oc1ccc(Cl)cc1Cl', 'CCNc1nc(Cl)nc(NC(C)C)n1',
    'ClC(Cl)(Cl)C(c1ccc(Cl)cc1)c1ccc(Cl)cc1',
    'CCC1(C(=O)NC(=O)NC1=O)c1ccccc1', 'CCN(CC)CC(=O)Nc1c(C)cccc1C',
    'CC(C)NCC(O)COc1cccc2ccccc12', 'CNCCC(Oc1ccc(cc1)C(F)(F)F)c1ccccc1',
    'CNC1CCC(c2ccc(Cl)c(Cl)c2)c2ccccc12',
    'CCC(=C(c1ccccc1)c1ccc(OCCN(C)C)cc1)c1ccccc1',
    'CN(C)CCCN1c2ccccc2Sc2ccc(Cl)cc21',
    'OC1(CCN(CCCC(=O)c2ccc(F)cc2)CC1)c1ccc(Cl)cc1',
    'COc1ccc2[nH]c(nc2c1)S(=O)Cc1ncc(C)c(OC)c1C',
    'OC(=O)c1cn(C2CC2)c2cc(N3CCNCC3)c(F)cc2c1=O',
    'Cc1cc(NS(=O)(=O)c2ccc(N)cc2)no1', 'COc1cc(Cc2cnc(N)nc2N)cc(OC)c1OC',
    'CC1(C)SC2C(NC(=O)C(N)c3ccc(O)cc3)C(=O)N2C1C(=O)O',
    'CCCCc1nc(Cl)c(CO)n1Cc1ccc(cc1)-c1ccccc1-c1nn[nH]n1',
    'COc1ccc(CCN(C)CCCC(C#N)(C(C)C)c2ccc(OC)c(OC)c2)cc1OC',
    'COC(=O)C1=C(C)NC(C)=C(C1c1ccccc1[N+](=O)[O-])C(=O)OC',
    'c1ccc2c(c1)cc1ccc3cccc4ccc2c1c34', 'Oc1ccc(cc1)[N+](=O)[O-]',
    'Oc1ccc(cc1)-c1coc2cc(O)cc(O)c2c1=O',
    'Oc1cc(O)c2c(c1)oc(-c1ccc(O)c(O)c1)c(O)c2=O',
    'CC1CC2C3CCC4=CC(=O)C=CC4(C)C3(F)C(O)CC2(C)C1(O)C(=O)CO',
    'CC(=O)C1CCC2C3CCC4=CC(=O)CCC4(C)C3CCC12C',
    'CC(C)C(=O)Nc1ccc(c(c1)C(F)(F)F)[N+](=O)[O-]',
    'CC1(OC(=O)N(C1=O)c1cc(Cl)cc(Cl)c1)C=C',
    'COc1ccc(cc1)C(c1ccc(OC)cc1)C(Cl)(Cl)Cl', 'CCCCCCCCCc1ccc(O)cc1',
    'CCCCOC(=O)c1ccccc1C(=O)OCCCC', 'NC(=O)N1c2ccccc2C=Cc2ccccc21',
    'OC(=O)CNCP(=O)(O)O', 'Oc1c(Cl)c(Cl)c(Cl)c(Cl)c1Cl',
    'O=C1NC(=O)C(N1)(c1ccccc1)c1ccccc1',
    'Cc1ccc(cc1)-c1cc(nn1-c1ccc(cc1)S(N)(=O)=O)C(F)(F)F',
]
REQUESTS = (1, 16, 31)          # molecules per predict_on_batch request
# bench.py:56-66: GraphConvModel on Tox21's 12 tasks
GRAPHCONV = dict(n_tasks=12, graph_conv_layers=[64, 64],
                 dense_layer_size=128, batch_size=256,
                 mode='classification', learning_rate=0.002)
GRAPHCONV_MOLECULES = 768       # the 48 SMILES 16 times: 3 batches of 256
LATENCY_REQUESTS = 30           # requests of 16 molecules, timed one by one
#                                 (cut from 100 with the profile windows
#                                 when phase 23 took the script to 1437.5
#                                 s of its 1200 on an H100's host)
ROC_ATOL = 1e-6                 # evaluate's ROC-AUC, card against CPU
# phase 15: the engine at bench.py's width over 30 batches of 256
ENGINE_MOLECULES = 7680         # the 48 SMILES 160 times
ENGINE_VALID = 768              # the validation and uncertainty set
ENGINE_SCHEDULE = (0.002, 0.9, 10)    # ExponentialDecay, staircase
ENGINE_INTERVAL = 10            # steps between validations
ENGINE_CHUNK = 5                # batches a streamed chunk
UNCERTAINTY_MASKS = 50
UNCERTAINTY_RTOL = 1e-5         # kernels against plain, of max(1, |ref|)
STREAM_MEMORY_SLACK = 1.1       # streamed peak over 2 chunks + working set
SCORE_ATOL = 1e-12              # evaluate_on_device against evaluate
# graph_models.py:644-669: MPNNModel at the JAX package's defaults (30 atom
# and 11 bond features, T 3, M 6, node_dim 64, batch 100), one regression
# task
MPNN = dict(n_tasks=1, mode='regression')
MPNN_MOLECULES = 300            # 3 batches of 100
# cis/trans double bonds, beside the 48: MolGraphConvFeaturizer's stereo
# one-hot reads their marks
STEREO_SMILES = ['C/C=C/C', 'F/C=C\\F', 'O=C(O)/C=C/c1ccccc1',
                 'C/C=C\\C(=O)O', 'CC/C=C(/C)C1CCCC1', 'OC(=O)/C=C\\C(=O)O']
EVAL_ATOL = 1e-6                # evaluate's regression scores, card vs CPU
# the same, of max(1, |score|), for a model whose activations reach
# hundreds (model_phase's scaled): float32 alone moves CGCNN's MAE after 3
# epochs by 1.08e-6 from its float64 value, and its answers at the initial
# weights by 1.27e-4 (scripts/materials_float32_drift.py, on the CPU)
EVAL_SCALED_RTOL = 1e-5
# a classifier's ROC-AUC on the card may differ from the CPU's by the
# share of (positive, negative) pairs that the answers' own difference can
# swap (auc_tie_slack), that difference being within CPU_ATOL; never more
# than this (about twice the largest share seen, 4.38e-4: MAT on an
# H100, chip_smoke.py's own run)
AUC_SLACK_MAX = 1e-3
# graph_models.py:526-612 and dmpnn.py:94-121: GCN (layers 64, 64,
# predictor 128), GAT (layers 8, 8 of 8 heads, predictor 128), AttentiveFP
# (2 layers of 200) and DMPNN (hidden 300, depth 3, FFN 300 x 3) at the JAX
# package's defaults, batch 100, one regression task
GCN = dict(n_tasks=1, mode='regression')
GAT = dict(n_tasks=1, mode='regression')
ATTENTIVEFP = dict(n_tasks=1, mode='regression')
DMPNN = dict(n_tasks=1, mode='regression')
TABLE_MOLECULES = 300           # 3 batches of 100
# pna.py:121, gnn_modular.py:198 and infograph.py:114: PNA (hidden 64, 3
# layers, mean, max, min and std under identity, amplification and
# attenuation, residual), GNNModular (emb_dim 64, 3 GCN layers) as a
# regressor and on edge prediction, and InfoGraph* (embedding 64, 3
# layers) at the JAX package's defaults, batch 100, one regression task,
# on the phase 13 molecules
PNA = dict(n_tasks=1)
# phase 17: the COO branches, at phase 11's and 13's sizes; each held
# against its table path on the card within the JAX package's tests'
# tolerance
COO_RTOL, COO_ATOL = 1e-4, 1e-5
# phase 18: the fingerprint models at molnet/run_benchmark.py's presets
FP_BITS = 1024
DENSE_MOLECULES = 768           # the 48 SMILES 16 times
DENSE_TASKS = 12
TF = dict(n_tasks=DENSE_TASKS, n_features=FP_BITS, layer_sizes=[1500],
          dropouts=0.5, weight_decay_penalty=0.1,
          weight_decay_penalty_type='l2', batch_size=50, learning_rate=0.001)
TF_ROBUST = dict(n_tasks=DENSE_TASKS, n_features=FP_BITS, layer_sizes=[500],
                 bypass_layer_sizes=[100], dropouts=0.5, bypass_dropouts=0.5,
                 batch_size=50, learning_rate=0.0005)
TF_REGRESSION = dict(n_tasks=DENSE_TASKS, n_features=FP_BITS,
                     layer_sizes=[1000, 1000], dropouts=0.25, batch_size=128,
                     learning_rate=0.0008)
PROGRESSIVE = dict(n_tasks=DENSE_TASKS, n_features=FP_BITS)
IRV_K = 10
SCSCORE = dict(n_features=FP_BITS)
SINGLETASK_TASKS = 3            # MultitaskRegressor(1 task) a task
GNN_REGRESSION = dict(task='regression', n_tasks=1)
GNN_EDGE_PRED = dict(task='edge_pred')
INFOGRAPH_STAR = dict(n_tasks=1)
# scripts/bench_pallas_csr.py:76-78, (nodes, edges, features)
P2_BENCH_SHAPES = [(2048, 4096, 64), (2048, 4096, 256),
                   (8192, 16384, 256), (8192, 16384, 512),
                   (16384, 32768, 512)]
# P2's synthetic long segments: a hub node's in-edges (F 64), and one
# segment of 4096 edge rows at F 300, longer than any model path's (DMPNN
# COO's longest ghost range, recorded in training, is 1552 rows)
P2_HUB_EDGES = 2000
P2_LONG_EDGES = 4096
# DMPNN COO's training epoch that phase 3 records P2 at, as
# scripts/profile_torch_pagtn.py draws it: batches of 100 molecules
FIT_DRAW_BATCHES = 20
# phase 19: Weave at molnet/run_benchmark.py's 'weave' preset on phase 11's
# molecules; DAG at the JAX package's defaults on phase 13's; DTNN at its
# defaults on CoulombMatrix(max_atoms=23), qm7's width, of the SMILES of at
# most 23 atoms, and MultitaskFitTransformRegressor on CoulombFitTransformer
# of the same matrices (dropout 0, so the card draws as the CPU does)
WEAVE = dict(n_tasks=12, mode='classification', n_graph_feat=128,
             n_hidden=50, n_weave=2, batch_size=64, learning_rate=0.0005)
DAG = dict(n_tasks=1, mode='regression', max_atoms=50, n_graph_feat=30,
           batch_size=100)
DAG_LEVELS = 12                 # min(max_atoms, 12) passes, each P2 once
DTNN = dict(n_tasks=1)
QM7_ATOMS = 23
COULOMB_MOLECULES = 300         # 3 batches of 100
FIT_TRANSFORM = dict(n_tasks=1, n_features=[QM7_ATOMS, QM7_ATOMS],
                     layer_sizes=[1000], dropouts=0.0, batch_size=100)
# phase 20: material_models.py:57-89 CGCNNModel (atom_fea_len 64, 3
# convolutions, h_fea_len 128, batch 32) on CGCNNFeaturizer() (radius 8, 12
# neighbours, step 0.2: 92 atom and 41 edge features), :177-193 LCNNModel
# (width 44, 2 convolutions, head 64) on LCNNFeaturizer(), :150-174
# MEGNetModel (dim 32, 1 block) on CGCNNFeaturizer(), :216-226 ElemNetModel
# on ElemNetFeaturizer (dropout 0 here, so the card draws as the CPU does;
# 0.2, the JAX module's rate, is checked apart), at the JAX package's
# defaults, one regression task; MultitaskRegressor (fcnet.py, [1000],
# dropout 0, batch 100) on SineCoulombMatrix() and on
# ElementPropertyFingerprint(), z-scored; gnn3d.py:156-196
# InfoMax3DModular (hidden 64, 3 layers, batch 32) pretrained, then a
# regressor loaded from it, on the 48 SMILES with RDKitConformerFeaturizer
CGCNN = dict(n_tasks=1)
LCNN = dict(n_tasks=1)
MEGNET = dict(n_tasks=1)
ELEMNET = dict(n_tasks=1, dropout=0.0)
MATERIAL_REGRESSOR = dict(n_tasks=1, dropouts=0.0)
INFOMAX3D = dict(hidden_dim=64, num_layers=3, batch_size=32)
# MEGNet's answers at its initial weights barely differ between crystals
# (0.025 to 0.035 on the first batch): at lr 0.001 its loss on a fixed
# batch falls below 0.9 of its first in 54 steps (CPU), not 50
MEGNET_OVERFIT_STEPS = 100
CRYSTAL_COUNT = 320             # 10 batches of 32
CONFORMER_MOLECULES = 320       # the 48 SMILES shuffled: 10 batches of 32
# phase 21: mxmnet.py:124-137 MXMNetModel (dim 64, 3 layers, batch 32) on
# MXMNetFeaturizer() (radius 5, 16 neighbours); atomic_conv.py:186-230
# AtomicConvModel (fragments of 70, 634 and 701 atoms, 12 neighbours,
# layers 32, 32, 16, batch 24) on AtomicConvFeaturizer() complexes;
# low_data.py:156-161 SupportGraphClassifier at its defaults on
# MolGraphConvFeaturizer graphs; graph_layers.py:398 EGNNLayer at hidden 64
MXMNET = dict(n_tasks=1)
MXMNET_MOLECULES = 320          # the 48 SMILES shuffled: 10 batches of 32
ATOMIC_CONV = dict(n_tasks=1)
ATOMIC_COMPLEXES = 72           # 3 batches of 24
LIGAND_ATOMS = (40, 71)         # heavy atoms, drawn in [40, 70]
POCKET_ATOMS = (560, 631)
FEWSHOT = dict(n_pos=1, n_neg=9, n_test=16, n_feat=64, layer_sizes=(64, 64),
               max_depth=3)
FEWSHOT_MOLECULES = 192
FEWSHOT_TASKS = 4
FEWSHOT_EPISODES = 16           # an epoch: 4 a task
FEWSHOT_OVERFIT_STEPS = 50
EGNN_HIDDEN = 64
EGNN_GRAPHS = 32
# phase 22: scripts/bench_grover_mfu.py:177 'large', the JAX package's
# stand-in for GROVER-large (hidden 1024, 8 heads, 2 MT blocks, depth 3,
# batch 256), pretraining with both vocabularies and finetuning on 12
# classification tasks, each in both batch layouts; mat.py MATModel at the
# published MAT width (model dim 1024, 8 layers, 16 heads, lambda_attention
# = lambda_distance = 0.33), batch 32, 12 classification tasks
GROVER = dict(hidden_size=1024, num_heads=8, num_mt_block=2, depth=3,
              batch_size=256)
GROVER_TASKS = 12
GROVER_MOLECULES = 768          # the 48 SMILES 16 times: 3 batches of 256
# the CPU follows GROVER-large on small inputs (model_phase's cpu_cut):
# requests against a CPU model of batch 32, training at batch 8
GROVER_CPU_CUT = (32, 8)
GROVER_CUT_QUANTUM = 64         # the flat layout's quanta at those batches
GROVER_PROFILE_CALLS = 1        # calls a profiler window (a step is ~1 s)
MAT = dict(dim=1024, n_layers=8, n_heads=16, lambda_attention=0.33,
           lambda_distance=0.33, batch_size=32, n_tasks=12,
           mode='classification')
MAT_MOLECULES = 192             # the 48 SMILES 4 times: 6 batches of 32
MAT_CPU_CUT = (32, 8)           # as GROVER's: 18 CPU steps took 60 s
MAT_PROFILE_CALLS = 2           # 20 a window took 47 s on an H100
# phase 23: the sequence and image models at the JAX package's defaults
SEQ_MOLECULES = 300             # the 48 SMILES shuffled: 3 batches of 100
SEQ_TASKS = 2
TEXTCNN = dict(n_tasks=SEQ_TASKS)           # classification, dropout 0.25
SMILES2VEC = dict(n_tasks=SEQ_TASKS)        # regression
SMILES2VEC_SEQ = dict(max_len=250, pad_len=10)      # 270 tokens
CHEMCEPTION = dict(n_tasks=SEQ_TASKS, img_size=80)  # regression
AUTOENCODER = dict(max_output_length=120)   # 512 wide, 4 + 4 GRU layers
ONEHOT_LENGTH = 100
CNN_1D = dict(n_tasks=SEQ_TASKS, n_features=35, dims=1, layer_filters=(100,),
              kernel_size=5, dense_layer_size=1000, dropouts=0.5)
IMAGES = 48                     # at least the requests' 1 + 16 + 31
UNET_SIZE = 256
INCEPTION_SIZE = 299
ONEFORMER_SIZE = 512            # ADE20K's crop
ONEFORMER = dict(id2label={0: 'background', 1: 'object'},
                 image_size=(ONEFORMER_SIZE, ONEFORMER_SIZE))
# the host follows these on small inputs: (request batch, training batch)
SEQ_CPU_CUT = (16, 8)
UNET_CPU_CUT = (2, 2)
INCEPTION_CPU_CUT = (8, 4)
ONEFORMER_CPU_CUT = (2, 2)
# InceptionV3's step-1 gradients at batch 4 of 299 x 299 are held at
# GRAD_ATOL but one: the last 3x3 convolution's bias, 1.30e-5 of max(1,
# |g|) from the CPU's on an H100 (the rest within 3.3e-6).  The card's
# float32 forward flips one ReLU after that convolution, at a
# pre-activation 1.6e-7 of the layer's largest (float64 as the
# reference; the CPU's flips none there): cuDNN's implicit-GEMM forward
# (sm80_xmma_fprop_implicit_gemm, FFMA) sums each output 3.6 times as far
# from float64 as the CPU does, and the bias gradient, a sum over 4 x 36
# x 36 positions, gains that position's cotangent
# (scripts/image_float32_drift.py --per-layer).  The channels-last
# pooling fault (ROADMAP F11) moved the gradients by 2.8e-3
INCEPTION_GRAD_ATOL_OF = {'blocks.1.convs.5.bias': 1.5e-5}
# UNet's fixed batch of 2 fell below 0.9 of its first loss at step 2 on
# an H100, where a step at that batch takes about 0.5 s
UNET_OVERFIT_STEPS = 10
# phase 24: bench.py's main path through the port's own entry points:
# load_tox21(featurizer='graphconv', splitter='random', splitter_seed=123)
# on a Tox21-shaped tox21.csv.gz written in a temporary data dir, then
# GraphConvModel at bench.py's width from the train DiskDataset
TOX21_ROWS = 8014               # Tox21's molecules (bench.py:7-8)
TOX21_SPLIT = (6411, 801, 802)  # bench.py's random split of 8014
TOX21_BAD = {100: 'C1CC', 4000: 'not_a_smiles', 8000: 'CC(('}   # rows
#                                 (before which) that do not parse
TOX21_EMPTY, TOX21_NA = 0.2, 0.01   # shares of label cells empty, 'NA'
MOLNET_EPOCHS = 3
# the card's training is held against the CPU's by its step-1 gradients
# (GRAD_ATOL, as phase 11); its losses are recorded, not held: GraphConv's
# trajectory at this batch amplifies float32 rounding about 1e4 times in
# 20 steps (weights 1 ulp apart on the CPU: within 1.4e-6 of max(1,
# |loss|) through step 10, up to 1.18e-3 by step 26;
# scripts/graphconv_trajectory_drift.py),
# and the card's own rounding parts it from the CPU's from step 5 (2.55e-5
# there, 1.77e-3 at step 10; the 3 epochs' losses 2.85e-4 apart; an H100
# at 700 W)
MOLNET_TRAJECTORY = 12          # fit steps whose losses are recorded
MOLNET_SEARCH_RATES = [0.002, 0.0005]
BALANCE_ATOL = 1e-12            # weights recomputed on the train arrays
KERNEL_ATOL = 1e-6              # P1: same f32 inputs, another summation order
SUM_RTOL = 1e-5                 # P3, P2: atol 1e-5 * max(1, max |out|)
SPIN_CYCLES = int(1e7)          # about 6 ms of the card's clock: device_us's
#                                 window waits behind it while the host
#                                 queues its calls
PROFILE_HEAD_LAUNCHES = 64      # empty kernels device_us launches first in
#                                 each profiler session
CPU_ATOL = 1e-4                 # whole model, f32, another summation order
GRAD_ATOL = 1e-5                # step-1 gradients, card against the CPU
# GROVER at hidden 1024 (batch 8, 3 seeds, both layouts and tasks): float32
# alone puts its step-1 gradients up to 1.34e-3 of max(1, |g64|) from
# float64 on the CPU and 2.23e-3 on the card (the grouped MPN's W_h and
# the edge attention's value and out biases; scripts/grover_float32_drift.py,
# H100), so the card's and the CPU's may lie 3.6e-3 apart: phase 22 holds
# GROVER's step-1 gradients, card against CPU, within this.  Faults
# planted in the backward of the flat layout's sums and gathers on real
# rows move them by 0.060 to 0.84 (scripts/grover_grad_controls.py, CPU,
# seeds 1 and 2); a fault confined to the ghost row moves no parameter's
# gradient, and the attention biases (4 of pretraining's 98 parameters,
# 12-13 of finetuning's 72) have gradients below this limit throughout
GROVER_GRAD_ATOL = 5e-3
TRAIN_RTOL = 1e-4               # 12-step loss trajectory, card against CPU
HBM_BYTES_PER_S = 3.35e12       # H100 SXM published peaks
F32_OPS_PER_S = 67e12           # FMA units
BF16_OPS_PER_S = 989e12         # dense, tensor cores
TF32_OPS_PER_S = 494.7e12       # dense, tensor cores
TF32_PASSES = 3                 # P4 in f32: 3xTF32 on the tensor cores
# scripts/bench_chemberta_mfu.py:44-70: the ChemBERTa-77M-class encoder
ENCODER = dict(vocab_size=600, hidden=768, layers=12, heads=12,
               intermediate=3072, max_positions=130)
SEQ = 128                       # tokens a sequence, padded
ENCODER_BATCH = 16              # training batch
ENCODER_LR = 1e-4               # the benches' optax.adamw rate
FLASH_MAIN = (32, 12, 128, 64)  # the encoder's attention, [B, H, S, D]
# scripts/attn_crossover.py:27-35: H = 12, D = 64, 65 536 tokens a call
CROSSOVER_TOKENS = 65536
CROSSOVER_S = (128, 256, 512, 1024, 2048, 4096)
F32_CROSSOVER_S = (512, 4096)   # P4 in f32 at these too
# timed calls a crossover case (a quarter from S 2048), halved from 200
# to make room for phase 21 and again for phase 22
CROSSOVER_ITERS = 25
PLAIN_ROWS_FROM_S = 2048        # from here the plain version takes 2 rows
# P4 against the plain version in float32 from the same inputs, scaled by
# max(1, |ref|): forward, then gradients; bfloat16 rounds p, ds and outputs
FLASH_TOL = {'float32': (1e-5, 1e-4), 'bfloat16': (2e-2, 5e-2)}
# and the bfloat16 o and each bfloat16 gradient within these of their own
# max |ref|, no floor: at phase 6's shapes sound o reads up to 0.0031 of it
# and the forward with one fault put in 0.0107 or more, sound gradients up
# to 0.0057 and the formulas with one fault 0.024 or more (H100,
# scripts/flash_controls.py)
FLASH_FWD_RTOL = 7e-3
FLASH_GRAD_RTOL = 1e-2
ROUTE_TOL = {'float32': 1e-4, 'bfloat16': 2e-2}   # flash against einsum
# the forward's m and l against the plain version's, each within this of
# max(1, |ref|): the same scores summed in another order, exp by ex2.approx
STAT_RTOL = 1e-5


_PHASE = [None, 0.0]          # the phase running and when it started
PARTIAL_WINDOWS = []          # device_us readings with records missing
_START = time.perf_counter()  # the script's start, for its wall


def phase_start(n: int) -> None:
    """Print the wall time of the phase that ran before phase ``n``."""
    now = time.perf_counter()
    if _PHASE[0] is not None:
        print(f'phase {_PHASE[0]} wall: {now - _PHASE[1]:.1f} s', flush=True)
    _PHASE[:] = [n, now]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f'check failed: {what}')


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean ms per call of ``fn``, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls.  Where a call's host work
    outlasts its kernels, this is the host's cost per call."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, kernel: str, bound_us: float = 0.0, calls: int = 20,
              tries: int = 5) -> float:
    """Device µs per launch of the kernel whose name holds ``kernel``, from
    ``torch.profiler`` over ``calls`` calls of ``fn``; each call must
    launch it once.  Each profiler session first runs one call outside
    the timed window: a session's first launch waited about 0.6 ms for
    the profiler (a 61 µs kernel then filled 0.65-0.70 of its window on
    an H100).  The profiler has been seen to drop a kernel record
    of a run and to read a kernel at half its time (torch 2.11, CUDA
    12.8), so a run counts only if its mean is at least ``bound_us`` and
    it agrees with the card's clock where that can be read: where the
    host queued the calls in under half the time the card took for them
    (CUDA events around the run), the card was never idle, and its device
    records, a dropped launch counted at the mean, must fill at least 0.7
    of that time; elsewhere every launch must have been recorded.  The
    card also waits behind a spin kernel (SPIN_CYCLES) while the host
    queues the calls: where the host queued them all before the spin
    ended, the card ran them back to back, and a window whose records
    fill 0.7 of its time counts too.  So a kernel as short as its host's
    launch (GROVER's K = 9 to-bond K1, 40 µs) is read even where the
    profiler kept 11 of its 21 records (in some processes on an H100; a
    fresh process kept every record; why is not known); a kernel of a few
    µs, whose back-to-back launches leave gaps, fills less than 0.7 of
    its window even with every record.  The records lost were a
    session's first ones (its call before the window, then the spin
    kernel's), so each session starts with PROFILE_HEAD_LAUNCHES empty
    spin kernels, which no count or busy time includes.  Where no run
    counts after ``tries`` runs, a run whose calls were all queued behind
    the spin and which recorded the kernel is read by the card's clock
    alone: the CUDA events' time over ``calls``, which holds the launch
    gaps and whatever else ``fn`` launches, so it is never below the
    kernel's time (a 1.85 µs GROVER readout, 13 of 21 records, filled
    0.58 of its window in five runs: H100, torch 2.11).  Every reading
    taken from a window with records missing, or by the events, is
    printed with its kept and expected records, how many of those ran
    before the spin ended (None where the spin's record is lost), how
    many empty kernels were kept, and the rule that read it, and kept in
    PARTIAL_WINDOWS, which the kernels line's phase prints.  The check
    fails if no run counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    spin = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs, by_events = [], []

    def partial(count, mean, filled, before_spin, heads, rule):
        PARTIAL_WINDOWS.append({
            'kernel': kernel, 'records': count, 'expected': calls + 1,
            'before_spin': before_spin, 'heads_kept': heads,
            'device_us': round(mean, 3),
            'filled': round(filled, 3), 'rule': rule})
        print(f'device_us: {json.dumps(PARTIAL_WINDOWS[-1])}', flush=True)

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_HEAD_LAUNCHES):
                torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
            spin.record()
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            host_us = (time.perf_counter() - t0) * 1e6
            end.record()
            torch.cuda.synchronize()
        spin_us = spin.elapsed_time(start) * 1e3
        card_us = start.elapsed_time(end) * 1e3
        # count and busy include the call before the window, not the spin
        total, count, busy = 0.0, 0, 0.0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA \
                    and 'spin_kernel' not in evt.key:
                busy += evt.self_device_time_total
                if kernel in evt.key:
                    total += evt.self_device_time_total
                    count += evt.count
        mean = total / count if count else 0.0
        filled = (busy + (calls - count) * mean) / card_us
        runs.append((count, round(mean, 2), round(filled, 3),
                     round(host_us / card_us, 3), round(spin_us, 1)))
        counted = filled >= 0.7 if host_us < 0.5 * card_us \
            else count == calls + 1
        # every call queued behind the spin: the card ran them back to back
        queued = host_us < spin_us and filled >= 0.7
        kept = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        spins = [e.time_range for e in kept if 'spin_kernel' in e.key]
        # the spin runs for ms, an empty kernel for µs
        spin_end = [r.end for r in spins if r.end - r.start > 1000]
        heads = len(spins) - len(spin_end)
        before_spin = sum(e.time_range.start < spin_end[0] for e in kept
                          if kernel in e.key) if spin_end else None
        if 0 < count <= calls + 1 and mean >= bound_us \
                and (counted or queued):
            if count < calls + 1:
                partial(count, mean, filled, before_spin, heads,
                        'filled' if counted else 'queued')
            return mean
        if 0 < count and host_us < spin_us:
            by_events.append((card_us / calls, count, filled, before_spin,
                              heads))
    if by_events:
        per_call, count, filled, before_spin, heads = min(
            by_events, key=lambda r: r[0])
        if per_call >= bound_us:
            partial(count, per_call, filled, before_spin, heads, 'events')
            return per_call
    check(False, f'{kernel}: no profile of {calls} calls counted (launches, '
          f'µs a launch, share of the card time filled, host time / card '
          f'time, spin µs): {runs}; bound {bound_us:.3f} µs')


def device_us_all(fn, calls: int = 5, tries: int = 1, most: int = 5,
                  top: int = 0):
    """Device µs a call of ``fn`` over every CUDA kernel (and memset or
    copy) it launches, and the kernels a call, from ``torch.profiler``
    windows of ``calls`` calls.  Per kernel name: its mean time a record,
    times its launches a call (its records over ``calls``, rounded up; the
    most of ``tries`` windows).  The profiler can drop records of a window
    (see :func:`device_us`): that moves a mean little, and a kernel
    launched the same number of times each call reads its count while it
    loses fewer records than ``calls``, so one window is enough; it has
    been seen to record no device event in two windows running (torch
    2.11, CUDA 12.8): while it has recorded none it profiles again, up to
    ``most`` windows.  With ``top``, also the ``top`` kernels that take
    most of a call: ``[name, device µs a call]``, longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = {}                     # name: (records, total µs)
    for window in range(most):
        if window >= tries and seen:
            break
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                seen[e.key] = max(seen.get(e.key, (0, 0.0)),
                                  (e.count, e.self_device_time_total))
    per_call = {k: -(-n // calls) for k, (n, _) in seen.items()}
    check(bool(seen), 'the profiler recorded a device event')
    busy = {k: t / n * per_call[k] for k, (n, t) in seen.items()}
    out = (sum(busy.values()), sum(per_call.values()))
    if top:
        out += ([[k, v] for k, v in sorted(busy.items(),
                                           key=lambda kv: -kv[1])[:top]],)
    return out


def bound(nbytes: int, ops: int, ops_per_s: float = F32_OPS_PER_S):
    """The least time for the work, ms, and what sets it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def max_err(a, b) -> float:
    return (a - b).abs().max().item() if a.numel() else 0.0


def sum_tol(ref) -> float:
    return SUM_RTOL * max(1.0, ref.abs().max().item() if ref.numel()
                          else 0.0)


def library_softmax(logits, row_ptr):
    """The segment softmax as one PyTorch library call, for comparison
    only: ``torch.sparse.softmax`` over a sparse ``[N, E, H]`` tensor whose
    rows are the segments.  Unspecified entries count as -inf, so each
    row's softmax is its segment's.  The COO index it needs is built from
    ``row_ptr`` here, and is timed with the call."""
    import torch
    E, H = logits.shape
    N = row_ptr.shape[0] - 1
    edges = torch.arange(E, dtype=torch.int32, device=logits.device)
    seg = torch.searchsorted(row_ptr[1:], edges, right=True)
    coo = torch.sparse_coo_tensor(
        torch.stack([seg, edges.long()]), logits, (N, E, H),
        is_coalesced=True, check_invariants=False)
    return torch.sparse.softmax(coo, dim=1).values()


def library_segment_sum(msgs, row_ptr):
    """P3's function as one library call, for comparison only."""
    import torch
    return torch.segment_reduce(msgs, 'sum', offsets=row_ptr.long(), axis=0)


def library_neighbor_sum(h, src, row_ptr):
    """P2's function as one library call, for comparison only: a CSR
    adjacency times ``h``; the CSR tensor is built inside the timed call."""
    import torch
    E = src.shape[0]
    adj = torch.sparse_csr_tensor(
        row_ptr, src, torch.ones(E, dtype=h.dtype, device=h.device),
        (row_ptr.shape[0] - 1, h.shape[0]), check_invariants=False)
    return torch.sparse.mm(adj, h)


def softmax_case(name, logits, row_ptr):
    """P1 kernel and library call against the plain version on the card,
    with times and bound."""
    import torch
    from deepchem_tpu_torch.ops.csr_segment import (
        csr_segment_softmax, csr_segment_softmax_reference)
    y = csr_segment_softmax(logits, row_ptr)
    again = csr_segment_softmax(logits, row_ptr)
    torch.cuda.synchronize()
    y_ref = csr_segment_softmax_reference(logits, row_ptr)
    err = max_err(y, y_ref)
    # the library gives NaN where a segment's head has no finite logit;
    # the kernel, like the TPU's, gives 0 there
    y_lib = library_softmax(logits, row_ptr)
    nan = ~torch.isfinite(y_lib)
    check(bool((y_ref[nan] == 0).all()),
          f'{name}: library NaN only where no logit is finite')
    lib_err = (y_lib - y_ref)[~nan].abs().max().item()
    E, H = logits.shape
    N = row_ptr.shape[0] - 1
    # each input read once, the output written once; ~8 operations an
    # element (max, subtract, exp, add; subtract, exp, divide, rescale)
    bound_ms, bound_by = bound(2 * E * H * 4 + (N + 1) * 4, 8 * E * H)
    res = {'kernel': 'csr_segment_softmax', 'case': name, 'E': E, 'H': H,
           'N': N, 'max_abs_err': err,
           'repeat_identical': torch.equal(y, again),
           'ms': time_ms(lambda: csr_segment_softmax(logits, row_ptr)),
           'device_us': device_us(
               lambda: csr_segment_softmax(logits, row_ptr),
               'csr_segment_softmax_kernel', bound_ms * 1e3),
           'plain_ms': time_ms(
               lambda: csr_segment_softmax_reference(logits, row_ptr)),
           'library_err': lib_err,
           'library_ms': time_ms(lambda: library_softmax(logits, row_ptr)),
           'bound_ms': bound_ms, 'bound_by': bound_by}
    res['library_device_us'], res['library_kernels'] = device_us_all(
        lambda: library_softmax(logits, row_ptr))
    print(f'phase 3 kernel {json.dumps(res)}', flush=True)
    check(err <= KERNEL_ATOL, f'{name}: kernel error {err} > {KERNEL_ATOL}')
    check(lib_err <= KERNEL_ATOL,
          f'{name}: library error {lib_err} > {KERNEL_ATOL}')
    check(res['repeat_identical'], f'{name}: a repeat differs')
    return res


def softmax_grad_case(name, logits, row_ptr, seed=0):
    """P1's Function (kernel forward, P3 in the backward) against autograd
    through the plain version, both on the card."""
    import numpy as np
    import torch
    from deepchem_tpu_torch.ops.csr_segment import (
        csr_segment_softmax, csr_segment_softmax_reference)
    w = torch.from_numpy(np.random.RandomState(seed).randn(
        *logits.shape).astype(np.float32)).to(logits.device)
    grads = []
    for fn in (csr_segment_softmax, csr_segment_softmax_reference):
        x = logits.detach().clone().requires_grad_()
        (fn(x, row_ptr) * w).sum().backward()
        grads.append(x.grad)
    err, tol = max_err(*grads), sum_tol(grads[1])
    res = {'kernel': 'csr_segment_softmax backward', 'case': name,
           'max_abs_err': err, 'finite': bool(torch.isfinite(grads[0]).all())}
    print(f'phase 3 kernel {json.dumps(res)}', flush=True)
    check(res['finite'], f'{name}: finite gradient')
    check(err <= tol, f'{name}: backward error {err} > {tol}')
    return res


def sum_case(name, msgs, row_ptr):
    """P3 kernel and library call against the plain version on the card."""
    import torch
    from deepchem_tpu_torch.ops.csr_segment import (
        csr_segment_sum, csr_segment_sum_reference)
    out = csr_segment_sum(msgs, row_ptr)
    again = csr_segment_sum(msgs, row_ptr)
    torch.cuda.synchronize()
    # the plain version in float64: in float32 its index_add_ sums a long
    # segment in an order that changes from run to run, and drifts by
    # about as much as the tolerance (40k edges: 2.3e-3 to 5.1e-3 of a
    # 4.9e-3 limit)
    ref = csr_segment_sum_reference(msgs.double(), row_ptr)
    err, tol = max_err(out.double(), ref), sum_tol(ref)
    plain_f32_err = max_err(
        csr_segment_sum_reference(msgs, row_ptr).double(), ref)
    used = int(row_ptr[-1])                   # edges past row_ptr[N] unread
    lib_in = msgs[:used]
    lib_err = max_err(library_segment_sum(lib_in, row_ptr).double(), ref)
    E, F = msgs.shape
    N = row_ptr.shape[0] - 1
    bound_ms, bound_by = bound(4 * (used * F + N * F + N + 1), used * F)
    res = {'kernel': 'csr_segment_sum', 'case': name, 'E': E, 'F': F,
           'N': N, 'max_abs_err': err, 'tol': tol,
           'plain_f32_err': plain_f32_err,
           'repeat_identical': torch.equal(out, again),
           'ms': time_ms(lambda: csr_segment_sum(msgs, row_ptr)),
           'device_us': device_us(lambda: csr_segment_sum(msgs, row_ptr),
                                  'csr_segment_sum_kernel', bound_ms * 1e3),
           'plain_ms': time_ms(
               lambda: csr_segment_sum_reference(msgs, row_ptr)),
           'library_err': lib_err,
           'library_ms': time_ms(
               lambda: library_segment_sum(lib_in, row_ptr)),
           'bound_ms': bound_ms, 'bound_by': bound_by}
    res['library_device_us'], res['library_kernels'] = device_us_all(
        lambda: library_segment_sum(lib_in, row_ptr))
    print(f'phase 3 kernel {json.dumps(res)}', flush=True)
    check(err <= tol, f'{name}: kernel error {err} > {tol}')
    check(lib_err <= tol, f'{name}: library error {lib_err} > {tol}')
    check(res['repeat_identical'], f'{name}: a repeat differs')
    return res


def gather_case(name, h, src, row_ptr):
    """P2 kernel and library call against the plain version on the card."""
    import torch
    from deepchem_tpu_torch.ops.csr_segment import (
        csr_neighbor_sum_reference, fused_gather_segment_sum)
    out = fused_gather_segment_sum(h, src, row_ptr)
    again = fused_gather_segment_sum(h, src, row_ptr)
    torch.cuda.synchronize()
    # the plain version in float64, as in sum_case
    ref = csr_neighbor_sum_reference(h.double(), src, row_ptr)
    err, tol = max_err(out.double(), ref), sum_tol(ref)
    plain_f32_err = max_err(
        csr_neighbor_sum_reference(h, src, row_ptr).double(), ref)
    lib_err = max_err(library_neighbor_sum(h, src, row_ptr).double(), ref)
    Nh, F = h.shape
    N = row_ptr.shape[0] - 1
    used = int(row_ptr[-1])
    rows = src[:used].unique().numel()        # rows of h the sums read
    rest = 4 * (used + N * F + N + 1)         # src, out, row_ptr
    bound_ms, bound_by = bound(4 * rows * F + rest, used * F)
    res = {'kernel': 'fused_gather_segment_sum', 'case': name,
           'N_h': Nh, 'E': src.shape[0], 'F': F, 'N': N,
           'longest_segment': int((row_ptr[1:] - row_ptr[:-1]).max()),
           'max_abs_err': err, 'tol': tol, 'plain_f32_err': plain_f32_err,
           'repeat_identical': torch.equal(out, again),
           'ms': time_ms(lambda: fused_gather_segment_sum(h, src, row_ptr)),
           'device_us': device_us(
               lambda: fused_gather_segment_sum(h, src, row_ptr),
               'fused_gather_segment_sum_kernel', bound_ms * 1e3),
           'plain_ms': time_ms(
               lambda: csr_neighbor_sum_reference(h, src, row_ptr)),
           'library_err': lib_err,
           'library_ms': time_ms(
               lambda: library_neighbor_sum(h, src, row_ptr)),
           'bound_ms': bound_ms, 'bound_by': bound_by,
           # each edge reading its row of h again, with no reuse
           'bound_no_reuse_ms': bound(4 * used * F + rest, used * F)[0]}
    res['library_device_us'], res['library_kernels'] = device_us_all(
        lambda: library_neighbor_sum(h, src, row_ptr))
    res['library_over_kernel'] = res['library_device_us'] / res['device_us']
    print(f'phase 3 kernel {json.dumps(res)}', flush=True)
    check(err <= tol, f'{name}: kernel error {err} > {tol}')
    check(lib_err <= tol, f'{name}: library error {lib_err} > {tol}')
    check(res['repeat_identical'], f'{name}: a repeat differs')
    return res


def library_neighbor_sum_bf16(h, src, dst, num_nodes):
    """P2's function in bfloat16 as PyTorch calls, for comparison only:
    ``index_select`` of the rows, then ``index_add_`` by each edge's
    segment ``dst`` (atomics: another order of the adds)."""
    return h.new_zeros((num_nodes, h.shape[1])).index_add_(
        0, dst, h.index_select(0, src))


# the first design of P2's bfloat16 kernel, for its launch floor: 8 warps
# a block, a group of the least power of two lanes >= a row's units (8
# values where F % 8 == 0 and h and out are 16-byte aligned, else one) a
# node, at most 32
P2_BF16_PARENT_WARPS = 8


def p2_bf16_parent_blocks(n_nodes: int, feat: int, aligned: bool = True
                          ) -> int:
    """Blocks of 256 threads that the first design of P2's bfloat16 kernel
    took for N nodes of F features."""
    units = feat // 8 if feat % 8 == 0 and aligned else feat
    lanes = 1
    while lanes < min(units, 32):
        lanes *= 2
    nodes = P2_BF16_PARENT_WARPS * (32 // lanes)
    return (n_nodes + nodes - 1) // nodes


def p2_bf16_floor_us(h, row_ptr) -> dict:
    """The launch floor of P2's bfloat16 kernel at these inputs: device µs
    of an empty kernel (``p2_empty_kernel``) at the grid and block that
    ``fused_gather_segment_sum_bf16`` takes for them, and at the grid and
    block of the kernel's first design; the floor is the smaller, so that
    a larger grid cannot lower the bar."""
    import torch
    from deepchem_tpu_torch.kernels import build
    N, F = row_ptr.shape[0] - 1, h.shape[1]
    stream = torch.cuda.current_stream(h.device).cuda_stream
    new_grid = build.c_entry('fused_gather_segment_sum',
                             'fused_gather_segment_sum_bf16_empty', 2, 2)
    any_grid = build.c_entry('fused_gather_segment_sum', 'p2_empty_launch',
                             0, 2)
    out = h.new_empty((N, F))
    blocks = p2_bf16_parent_blocks(N, F, h.data_ptr() % 16 == 0
                                   and out.data_ptr() % 16 == 0)

    def empty_new():
        check(new_grid(h.data_ptr(), out.data_ptr(), N, F, stream) == 0,
              'the empty kernel launches at the bf16 grid')

    def empty_parent():
        check(any_grid(blocks, 32 * P2_BF16_PARENT_WARPS, stream) == 0,
              'the empty kernel launches at the parent grid')
    res = {'new_grid_us': device_us(empty_new, 'p2_empty_kernel'),
           'parent_grid_us': device_us(empty_parent, 'p2_empty_kernel'),
           'parent_blocks': blocks}
    res['floor_us'] = min(res['new_grid_us'], res['parent_grid_us'])
    return res


def bf16_add_ns(dev, chain=None) -> dict:
    """ns a dependent add of P2's bfloat16 kernel (its own add, through
    ``p2_bf16_add_chain``, the package's or ``chain``): one thread adds 8
    values in turn, over and over, on a word of two values (``pair``) and
    on one value (``single``); CUDA events around chains of 8 * 4096 and
    8 * 32768 adds, the best of 5 each, and the latency is their
    difference over the adds between."""
    import numpy as np
    import torch
    from deepchem_tpu_torch.kernels import build
    chain = chain or build.c_entry('fused_gather_segment_sum',
                                   'p2_bf16_add_chain', 2, 2)
    # words of +1 and of -1 in both halves, so the sums stay at 0 and 1
    vals = torch.from_numpy(np.array([0x3f803f80, 0xbf80bf80] * 4,
                                     np.uint32).view(np.int32)).to(dev)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    res = {}
    for kind, pair in (('pair', 1), ('single', 0)):
        best = {}
        for steps in (1 << 12, 1 << 15):
            check(chain(vals.data_ptr(), out.data_ptr(), steps, pair,
                        stream) == 0, 'the add chain launches')
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                start.record()
                chain(vals.data_ptr(), out.data_ptr(), steps, pair, stream)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            best[steps] = min(times)
        res[kind] = (best[1 << 15] - best[1 << 12]) * 1e6 / (
            8 * ((1 << 15) - (1 << 12)))
    print(f'phase 3 bf16 add latency: {json.dumps(res)} ns', flush=True)
    return res


def bf16_same(a, b):
    """(bits equal, NaN where NaN and every other bit equal) of two
    bfloat16 tensors."""
    import torch
    ai, bi = a.view(torch.int16), b.view(torch.int16)
    na, nb = torch.isnan(a), torch.isnan(b)
    return (torch.equal(ai, bi),
            torch.equal(na, nb) and torch.equal(ai[~na], bi[~nb]))


def gather_bf16_case(name, h, src, row_ptr, add_ns, plain_iters=200):
    """P2's bfloat16 kernel against its plain version on the card, bit for
    bit (both add each segment's edges in CSR order, every add rounded to
    bfloat16) and repeat-identical, with times, bounds and the library
    call; both also against the float64 sum of the same bfloat16 inputs,
    recorded.  Bounds: ``bound_ms`` from bytes (each input read once, the
    output written once) and operations; the launch floor
    (:func:`p2_bf16_floor_us`); the order chain, the longest segment
    times one dependent add (``add_ns``, the faster of the two adds: a
    lower bound on either path).  ``least_ms`` is the largest of the
    three.  The plain version is timed over ``plain_iters`` calls (on
    long segments its slot-by-slot loop is slow, and it runs once)."""
    import torch
    from deepchem_tpu_torch.ops.csr_segment import (
        csr_neighbor_sum_reference, fused_gather_segment_sum)
    out = fused_gather_segment_sum(h, src, row_ptr)
    again = fused_gather_segment_sum(h, src, row_ptr)
    ref = csr_neighbor_sum_reference(h, src, row_ptr)
    torch.cuda.synchronize()
    same, same_but_nan = bf16_same(out, ref)
    f64 = csr_neighbor_sum_reference(h.double(), src, row_ptr)
    # errors where the plain version and the float64 sum are finite (a
    # bfloat16 sum overflows where the float64 one does not)
    finite = torch.isfinite(ref) & torch.isfinite(f64)
    Nh, F = h.shape
    N = row_ptr.shape[0] - 1
    used = int(row_ptr[-1])
    longest = int((row_ptr[1:] - row_ptr[:-1]).max()) if N else 0
    dst = torch.searchsorted(row_ptr[1:], torch.arange(
        used, dtype=torch.int32, device=h.device), right=True)
    lib_src = src[:used].long()
    lib_out = library_neighbor_sum_bf16(h, lib_src, dst, N)
    rows = src[:used].unique().numel()        # rows of h the sums read
    bound_ms, bound_by = bound(2 * rows * F + 4 * (used + N + 1)
                               + 2 * N * F, used * F)
    floor = p2_bf16_floor_us(h, row_ptr)
    order_ms = longest * min(add_ns.values()) * 1e-6
    least_ms, least_by = max((bound_ms, bound_by),
                             (floor['floor_us'] * 1e-3, 'launch floor'),
                             (order_ms, 'order chain'))
    res = {'kernel': 'fused_gather_segment_sum_bf16', 'case': name,
           'N_h': Nh, 'E': src.shape[0], 'F': F, 'N': N,
           'longest_segment': longest,
           'max_abs_err': max_err(out[finite].float(), ref[finite].float()),
           'bits_equal': same, 'nan_where_nan_rest_equal': same_but_nan,
           'tol': 'bit for bit',
           'err_f64': max_err(out.double()[finite], f64[finite]),
           'plain_err_f64': max_err(ref.double()[finite], f64[finite]),
           'repeat_identical': torch.equal(out.view(torch.int16),
                                           again.view(torch.int16)),
           'ms': time_ms(lambda: fused_gather_segment_sum(h, src, row_ptr)),
           'device_us': device_us(
               lambda: fused_gather_segment_sum(h, src, row_ptr),
               'fused_gather_segment_sum_bf16_kernel', bound_ms * 1e3),
           'plain_ms': time_ms(
               lambda: csr_neighbor_sum_reference(h, src, row_ptr),
               iters=plain_iters, warmup=min(10, plain_iters - 1)),
           'library_err_f64': max_err(
               lib_out.double()[finite & torch.isfinite(lib_out)],
               f64[finite & torch.isfinite(lib_out)]),
           'library_ms': time_ms(
               lambda: library_neighbor_sum_bf16(h, lib_src, dst, N)),
           'bound_ms': bound_ms, 'bound_by': bound_by,
           'launch_floor_ms': floor['floor_us'] * 1e-3,
           'empty_new_grid_us': floor['new_grid_us'],
           'empty_parent_grid_us': floor['parent_grid_us'],
           'order_bound_ms': order_ms, 'least_ms': least_ms,
           'least_by': least_by}
    res['share_of_least'] = least_ms * 1e3 / res['device_us']
    res['library_device_us'], res['library_kernels'] = device_us_all(
        lambda: library_neighbor_sum_bf16(h, lib_src, dst, N))
    print(f'phase 3 kernel {json.dumps(res)}', flush=True)
    check(same, f'{name}: the bfloat16 kernel differs from its plain '
          f'version (NaN where NaN, other bits equal: {same_but_nan})')
    check(res['repeat_identical'], f'{name}: a repeat differs')
    return res


def p2_bf16_non_finite_inputs(dev, feat, aligned=True):
    """P2's bfloat16 inputs at values that round, overflow and are not
    finite, from a generator of their own: 512 nodes with 0 to 3 edges
    from random rows, node 100 with 300 and the last with 1000 (long
    segments, summed by the block); h drawn element by element from
    ±inf, NaN, bfloat16 subnormals (±1e-40), ±0, ±3.3e38 (two of which
    overflow to ±inf), 1 and 256 (256 + 1 rounds back to 256) and normal
    values.  ``aligned=False`` puts h 2 bytes off 16-byte alignment."""
    import numpy as np
    import torch
    rng = np.random.RandomState(29)
    deg = rng.randint(0, 4, 512)
    deg[100], deg[-1] = 300, 1000
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    src = rng.randint(0, 512, int(row_ptr[-1])).astype(np.int32)
    special = np.array([np.inf, -np.inf, np.nan, 1e-40, -1e-40, 0.0, -0.0,
                        3.3e38, -3.3e38, 1.0, 256.0], np.float32)
    pick = rng.randint(0, len(special), (512, feat))
    h32 = np.where(rng.rand(512, feat) < 0.25, special[pick],
                   rng.randn(512, feat).astype(np.float32) * 100)
    h = torch.from_numpy(h32.astype(np.float32)).to(dev).to(torch.bfloat16)
    if not aligned:
        flat = torch.empty(h.numel() + 1, dtype=torch.bfloat16, device=dev)
        flat[1:] = h.reshape(-1)
        h = flat[1:].view(h.shape)
    return h, torch.from_numpy(src).to(dev), torch.from_numpy(row_ptr).to(dev)


def table_csr(table, deg):
    """The COO edges ``(src, dst)`` (int64) and the CSR ``(row_ptr, col)``
    (int32) of a neighbour table's real slots, for the library calls."""
    import torch
    from deepchem_tpu_torch.ops.nei_table import slot_mask
    real = slot_mask(table, deg)
    dst = torch.arange(table.shape[0], device=table.device)[:, None] \
        .expand_as(table)[real]
    src = table[real].long()
    row_ptr = torch.zeros(table.shape[0] + 1, dtype=torch.int32,
                          device=table.device)
    row_ptr[1:] = torch.cumsum(deg.long(), 0)
    return src, dst, row_ptr, src.to(torch.int32)


def library_nei_sum(h, row_ptr, col):
    """K1's function as one library call, for comparison only: the CSR
    adjacency ``[N, R]`` of the table's real slots times ``h`` ``[R, F]``;
    the CSR tensor is built inside the timed call."""
    import torch
    adj = torch.sparse_csr_tensor(
        row_ptr, col, torch.ones(col.shape[0], dtype=h.dtype,
                                 device=h.device),
        (row_ptr.shape[0] - 1, h.shape[0]), check_invariants=False)
    return torch.sparse.mm(adj, h)


def library_nei_max(h, src, dst):
    """K2's forward (the max only) as one library call, for comparison
    only: ``scatter_reduce_`` 'amax' of each edge's source row into its
    destination, self included."""
    idx = dst[:, None].expand(-1, h.shape[1])
    return h.clone().scatter_reduce_(0, idx, h[src], 'amax',
                                     include_self=True)


def library_nei_max_bwd(g, winner_idx):
    """K2's backward as one library call, for comparison only: each
    cotangent ``g[i, f]`` added into the row of its winner, which is ``i``
    or one of its neighbours (the table is undirected), so this sums the
    same terms as the kernel's gather.  ``winner_idx`` is the winners as
    int64, which ``scatter_add_`` takes, converted outside the timing."""
    import torch
    return torch.zeros_like(g).scatter_add_(0, winner_idx, g)


def library_graph_max(x, lengths, rows):
    """K3's forward (the max only, ties not averaged, no mask) as one
    library call, for comparison only."""
    import torch
    return torch.segment_reduce(x[:rows], 'max', lengths=lengths, axis=0)


def kernel_times(res, fn, plain, kernel, bound_ms, library=None):
    """Adds each call's time (kernel, plain, library), the kernel's
    device µs a launch and the library call's device µs to ``res``."""
    res.update({'ms': time_ms(fn), 'plain_ms': time_ms(plain),
                'device_us': device_us(fn, kernel, bound_ms * 1e3),
                'library_ms': time_ms(library) if library else None,
                'library_device_us': None, 'library_kernels': None})
    if library:
        res['library_device_us'], res['library_kernels'] = \
            device_us_all(library)
    return res


def nei_sum_case(name, h, table, deg):
    """K1 from the rows of ``h`` ``[R, F]`` through ``table`` ``[N, K]``
    (R == N for a neighbour table, R edges for MPNN's edge-id tables), and
    its library call, against the plain version on the card."""
    import torch
    from deepchem_tpu_torch.ops.nei_table import (_nei_sum_forward, nei_sum,
                                                  nei_sum_reference)

    def kernel():
        return _nei_sum_forward(h, table, deg, nei_sum)
    out = kernel()
    again = kernel()
    torch.cuda.synchronize()
    ref = nei_sum_reference(h, table, deg)
    err, tol = max_err(out, ref), sum_tol(ref)
    src, _, row_ptr, col = table_csr(table, deg)
    lib_err = max_err(library_nei_sum(h, row_ptr, col), ref)
    R, F = h.shape
    N = table.shape[0]
    slots = src.numel()
    rows = src.unique().numel()               # rows of h the sums read
    bound_ms, bound_by = bound(4 * (rows * F + slots + N * F) + N,
                               slots * F)
    res = {'kernel': 'nei_sum', 'case': name, 'N': N, 'R': R, 'F': F,
           'slots': slots, 'max_abs_err': err, 'tol': tol,
           'repeat_identical': torch.equal(out, again),
           'library_err': lib_err, 'bound_ms': bound_ms,
           'bound_by': bound_by}
    kernel_times(res, kernel,
                 lambda: nei_sum_reference(h, table, deg), 'nei_sum_kernel',
                 bound_ms, lambda: library_nei_sum(h, row_ptr, col))
    print(f'phase 3 kernel {json.dumps(res)}', flush=True)
    check(err <= tol, f'{name}: K1 error {err} > {tol}')
    check(lib_err <= tol, f'{name}: K1 library error {lib_err} > {tol}')
    check(res['repeat_identical'], f'{name}: a K1 repeat differs')
    return res


def library_nei_gather(x, table, mask):
    """K4's forward as one library call, for comparison only: every slot's
    row by ``index_select``, times the slot mask ``[N, K, 1]`` (float, made
    outside the timing)."""
    n, k = table.shape
    return x.index_select(0, table.view(-1)).view(n, k, -1) * mask


def nei_gather_cases(name, x, table, rev_slot, deg, g):
    """K4's forward (``x`` ``[N, ...]`` flattened to ``[N, C]``) and its
    backward (K1 of ``g`` ``[N, K, C]`` through the reverse-slot rows
    ``table * K + rev_slot``) against their plain versions on the card,
    bit for bit, and the library calls: ``index_select`` times the mask,
    and that call's autograd backward.  One result for each."""
    import torch
    from deepchem_tpu_torch.ops import nei_table
    n, k = table.shape
    x = x.reshape(n, -1).contiguous()
    C = x.shape[1]
    g = g.reshape(n * k, C).contiguous()
    rows = (table * k + rev_slot.to(table.dtype)).contiguous()

    def fwd():
        return nei_table._nei_gather_forward(x, table, deg)

    def bwd():
        return nei_table._nei_sum_forward(g, rows, deg, nei_table.nei_gather,
                                          'backward_launches')

    def plain_fwd():
        return nei_table.nei_gather_reference(x, table, deg)

    def plain_bwd():
        return nei_table.nei_sum_reference(g, rows, deg)
    out, again, grad, grad_again = fwd(), fwd(), bwd(), bwd()
    torch.cuda.synchronize()
    ref, ref_grad = plain_fwd(), plain_bwd()
    real = nei_table.slot_mask(table, deg)
    mask = real.to(x.dtype)[..., None]
    x_lib = x.detach().clone().requires_grad_()
    lib_out = library_nei_gather(x_lib, table, mask)
    g3 = g.view(n, k, C)

    def lib_bwd():
        return torch.autograd.grad(lib_out, x_lib, g3, retain_graph=True)[0]
    slots = int(real.sum())
    rows_read = table.unique().numel()           # pad slots' rows included
    fwd_ms, fwd_by = bound(4 * (rows_read * C + n * k + n * k * C) + n,
                           n * k * C)
    bwd_ms, bwd_by = bound(4 * (slots * C + slots + n * C) + n, slots * C)
    res = []
    for part, got, repeat, want, lib, kname, b_ms, b_by, fns in (
            ('forward', out, again, ref, lib_out.detach(), 'nei_gather_kernel',
             fwd_ms, fwd_by, (fwd, plain_fwd,
                              lambda: library_nei_gather(x, table, mask))),
            ('backward', grad, grad_again, ref_grad, lib_bwd(),
             'nei_sum_kernel', bwd_ms, bwd_by, (bwd, plain_bwd, lib_bwd))):
        r = {'kernel': f'nei_gather_{part}', 'case': name, 'N': n, 'K': k,
             'C': C, 'slots': slots, 'max_abs_err': max_err(got, want),
             'bit_identical': same_bits(got, want),
             'repeat_identical': same_bits(repeat, got),
             'library_err': max_err(lib, want), 'tol': sum_tol(want),
             'bound_ms': b_ms, 'bound_by': b_by}
        kernel_times(r, *fns[:2], kname, b_ms, fns[2])
        print(f'phase 3 kernel {json.dumps(r)}', flush=True)
        check(r['bit_identical'], f'{name}: K4 {part} differs from its plain '
              'version')
        check(r['repeat_identical'], f'{name}: a K4 {part} repeat differs')
        check(r['library_err'] <= r['tol'], f'{name}: K4 {part} library '
              f'error {r["library_err"]} > {r["tol"]}')
        res.append(r)
    return res


def more_non_finite_cases(dev):
    """K4's forward and backward on both kernel paths, and K1 at GCN's F 30
    (square table) and DMPNN's F 300 (4096 edge rows into 2048 nodes), on
    NaN, infinities and signed zeros, held for exact equality with the
    plain versions (:func:`same_bits`), from a generator of their own.
    Returns a result for each case."""
    import numpy as np
    import torch
    from deepchem_tpu_torch.ops import build_rev_slot, nei_table
    rng = np.random.RandomState(13)
    table, deg = random_table(rng, 1000, dev)
    real = nei_table.slot_mask(table, deg)
    rev = torch.from_numpy(build_rev_slot(
        table.cpu().numpy(), real.cpu().numpy().astype(np.float32))).to(dev)
    rows = table * 10 + rev.to(table.dtype)

    def values(n, C):
        a = rng.randn(n, C).astype(np.float32)
        a[rng.rand(n, C) < 0.2] = -0.0
        a[0, 0], a[0, -1] = np.inf, np.nan        # row 0: behind the pads
        a[rng.rand(n) < 0.1, C // 2] = -np.inf
        a[rng.rand(n) < 0.1, C - 1 - C // 3] = np.nan
        return torch.from_numpy(a).to(dev)
    results = []
    for C, tag, place in ((1, '', lambda t: t), (8, '', lambda t: t),
                          (64, '', lambda t: t), (200, '', lambda t: t),
                          (75, '', lambda t: t), (64, '_misaligned',
                                                  misaligned)):
        x, g = values(1000, C), values(10000, C)
        out = nei_table._nei_gather_forward(place(x), table, deg)
        again = nei_table._nei_gather_forward(place(x), table, deg)
        grad = nei_table._nei_sum_forward(place(g), rows, deg,
                                          nei_table.nei_gather,
                                          'backward_launches')
        torch.cuda.synchronize()
        results.append({'case': f'non_finite_gather_C{C}{tag}', 'checks': {
            'nei_gather': same_bits(out, nei_table.nei_gather_reference(
                x, table, deg)) and same_bits(again, out),
            'nei_gather_bwd': same_bits(grad, nei_table.nei_sum_reference(
                g, rows, deg))},
            'nan_outputs': int(torch.isnan(out).sum()
                               + torch.isnan(grad).sum())})
    e_table, e_deg = random_edge_table(rng, 2048, 4096, dev)
    for F, n, tab, dg in ((30, 1000, table, deg), (300, 4096, e_table, e_deg)):
        h = values(n, F)
        for tag, place in (('', lambda t: t), ('_misaligned', misaligned)):
            out = nei_table._nei_sum_forward(place(h), tab, dg,
                                             nei_table.nei_sum)
            torch.cuda.synchronize()
            results.append({'case': f'non_finite_sum_F{F}{tag}', 'checks': {
                'nei_sum': same_bits(out, nei_table.nei_sum_reference(
                    h, tab, dg))}, 'nan_outputs': int(torch.isnan(out).sum())})
    for res in results:
        print(f'phase 3 non-finite {json.dumps(res)}', flush=True)
        for kname, ok in res['checks'].items():
            check(ok, f'{res["case"]}: {kname} differs from its plain '
                  'version')
    return results


def nei_max_cases(name, h, table, deg, g):
    """K2's forward (max and winners) and backward against the plain
    versions on the card: one result for each kernel."""
    import torch
    from deepchem_tpu_torch.ops import nei_table
    fwd = lambda: nei_table._nei_max_forward(h, table, deg)  # noqa: E731
    out, winner = fwd()
    again, again_w = fwd()
    torch.cuda.synchronize()
    ref, ref_w = nei_table.nei_max_reference(h, table, deg)
    bwd = lambda: nei_table._nei_max_backward(  # noqa: E731
        g, table, deg, winner)
    grad, grad_again = bwd(), bwd()
    torch.cuda.synchronize()
    ref_grad = nei_table.nei_max_backward_reference(g, table, deg, winner)
    src, dst, _, _ = table_csr(table, deg)
    winner_idx = winner.long()
    N, F = h.shape
    slots = src.numel()
    tbl = 4 * slots + N                       # real slots, degrees
    results = []
    for part, (got, want, same, nbytes, kernel, fn, plain, lib) in {
            'fwd': (out, ref, torch.equal(out, again)
                    and torch.equal(winner, again_w),
                    4 * 3 * N * F + tbl, 'nei_max_fwd_kernel', fwd,
                    lambda: nei_table.nei_max_reference(h, table, deg),
                    lambda: library_nei_max(h, src, dst)),
            'bwd': (grad, ref_grad, torch.equal(grad, grad_again),
                    4 * 3 * N * F + tbl, 'nei_max_bwd_kernel', bwd,
                    lambda: nei_table.nei_max_backward_reference(
                        g, table, deg, winner),
                    lambda: library_nei_max_bwd(g, winner_idx))}.items():
        bound_ms, bound_by = bound(nbytes, slots * F)
        # the max is exact; the backward's sums may differ in order
        tol = sum_tol(want) if part == 'bwd' else 0.0
        res = {'kernel': f'nei_max_{part}', 'case': name, 'N': N, 'F': F,
               'slots': slots, 'max_abs_err': max_err(got, want),
               'tol': tol, 'repeat_identical': same,
               'library_err': max_err(lib(), want), 'bound_ms': bound_ms,
               'bound_by': bound_by}
        if part == 'fwd':
            res['winners_equal'] = torch.equal(winner, ref_w)
        kernel_times(res, fn, plain, kernel, bound_ms, lib)
        print(f'phase 3 kernel {json.dumps(res)}', flush=True)
        check(res['max_abs_err'] <= tol,
              f'{name}: K2 {part} error {res["max_abs_err"]} > {tol}')
        check(res.get('winners_equal', True), f'{name}: K2 winners differ')
        check(res['library_err'] <= tol,
              f'{name}: K2 {part} library error {res["library_err"]} > '
              f'{tol}')
        check(same, f'{name}: a K2 {part} repeat differs')
        results.append(res)
    return results


def graph_max_cases(name, x, row_ptr, mask, g):
    """K3's forward and backward against the plain versions on the card:
    one result for each kernel."""
    import torch
    from deepchem_tpu_torch.ops import segment
    fwd = lambda: segment._graph_max_forward(  # noqa: E731
        x, row_ptr, mask)
    out, mx, den = fwd()
    again = fwd()
    torch.cuda.synchronize()
    ref, ref_mx, ref_den = segment.graph_max_pool_reference(x, row_ptr,
                                                            mask)
    bwd = lambda: segment._graph_max_backward(  # noqa: E731
        g, x, row_ptr, mask, mx, den)
    dx, dx_again = bwd(), bwd()
    torch.cuda.synchronize()
    ref_dx = segment.graph_max_pool_backward_reference(g, x, row_ptr, mask,
                                                       mx, den)
    G = row_ptr.shape[0] - 1
    N, F = x.shape
    rows = int(row_ptr[-1])                   # rows in real graphs
    lengths = (row_ptr[1:] - row_ptr[:-1]).long()
    # the library call reads no mask: held where a graph has rows and
    # every one is valid
    valid_rows = torch.ones(rows, device=x.device) if mask is None \
        else (mask[:rows] > 0).float()
    full = (lengths > 0) & (torch.segment_reduce(
        valid_rows, 'sum', lengths=lengths) == lengths)
    lib_err = max_err(library_graph_max(x, lengths, rows)[full], ref[full])
    common = 4 * (rows * F + rows + G + 1)    # x, mask, row_ptr
    results = []
    for part, (got, want, same, nbytes, ops, kernel, fn, plain, lib) in {
            'fwd': (out, ref, all(torch.equal(a, b) for a, b in
                                  zip((out, mx, den), again)),
                    common + 4 * 3 * G * F, 2 * rows * F,
                    'graph_max_pool_fwd_kernel', fwd,
                    lambda: segment.graph_max_pool_reference(x, row_ptr,
                                                             mask),
                    lambda: library_graph_max(x, lengths, rows)),
            'bwd': (dx, ref_dx, torch.equal(dx, dx_again),
                    common + 4 * 3 * G * F + 4 * N * F, rows * F,
                    'graph_max_pool_bwd_kernel', bwd,
                    lambda: segment.graph_max_pool_backward_reference(
                        g, x, row_ptr, mask, mx, den), None)}.items():
        bound_ms, bound_by = bound(nbytes, ops)
        res = {'kernel': f'graph_max_pool_{part}', 'case': name, 'N': N,
               'F': F, 'G': G, 'max_abs_err': max_err(got, want),
               'tol': sum_tol(want), 'repeat_identical': same,
               'bound_ms': bound_ms, 'bound_by': bound_by}
        if part == 'fwd':
            res['stats_equal'] = torch.equal(mx, ref_mx) \
                and torch.equal(den, ref_den)
            res['library_err'] = lib_err
        kernel_times(res, fn, plain, kernel, bound_ms, lib)
        print(f'phase 3 kernel {json.dumps(res)}', flush=True)
        check(res['max_abs_err'] <= res['tol'],
              f'{name}: K3 {part} error {res["max_abs_err"]} > '
              f'{res["tol"]}')
        check(res.get('stats_equal', True), f'{name}: K3 max or count '
              'differs')
        check(lib_err <= res['tol'], f'{name}: K3 library error {lib_err}')
        check(same, f'{name}: a K3 {part} repeat differs')
        results.append(res)
    return results


def misaligned(a):
    """A contiguous copy of ``a`` whose data sits 4 bytes past a 16-byte
    boundary."""
    import torch
    out = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)[1:]
    return out.view(a.shape).copy_(a)


def random_table(rng, n, dev):
    """A random undirected graph of ``n`` nodes with degrees 0 to 10 (node
    0 has ten neighbours, the last 4 nodes none), its neighbour table and
    degrees on ``dev``."""
    import numpy as np
    import torch
    from deepchem_tpu_torch.ops import build_neighbor_table
    deg = np.zeros(n, int)
    src, dst = [], []
    pairs = [(0, j) for j in range(1, 11)] + [
        tuple(sorted(rng.randint(0, n - 4, 2))) for _ in range(3 * n)]
    for a, b in dict.fromkeys(pairs):
        if a != b and deg[a] < 10 and deg[b] < 10:
            src += [a, b]
            dst += [b, a]
            deg[a] += 1
            deg[b] += 1
    table, mask = build_neighbor_table(np.array(src), np.array(dst), n)
    return (torch.from_numpy(table).to(dev),
            torch.from_numpy(mask.sum(1).astype(np.int8)).to(dev))


def random_edge_table(rng, n, rows, dev):
    """An edge-id table of ``n`` nodes over ``rows`` edge rows, degrees 0
    to 10 (node 0 has ten, node n - 1 none), real entries random rows and
    pad entries 0, as the packer leaves them; and the degrees, on
    ``dev``."""
    import numpy as np
    import torch
    deg = rng.randint(0, 11, n).astype(np.int8)
    deg[0], deg[-1] = 10, 0
    table = rng.randint(0, rows, (n, 10)).astype(np.int32)
    table[np.arange(10)[None, :] >= deg[:, None]] = 0
    return torch.from_numpy(table).to(dev), torch.from_numpy(deg).to(dev)


def same_values(a, b) -> bool:
    """Equal shapes and values, NaN where NaN (-0.0 equals 0.0)."""
    import torch
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def same_bits(a, b) -> bool:
    """Equal shapes, NaN where NaN, and elsewhere equal values with equal
    sign bits (-0.0 differs from 0.0; a NaN's sign and payload are not
    compared)."""
    import torch
    nan = torch.isnan(a)
    return same_values(a, b) and torch.equal(torch.signbit(a[~nan]),
                                             torch.signbit(b[~nan]))


# logits of P1's non-finite case, each put into a segment of every length
# of SOFTMAX_NON_FINITE_LENGTHS, in every head: +inf, NaN, -inf, a logit
# whose exp overflows float32 (100), finite ones; a +inf or NaN makes the
# JAX kernel's max not finite, so its m is 0 and its sum +inf or NaN
SOFTMAX_NON_FINITE = {'inf_3_1': [float('inf'), 3.0, 1.0],
                      'nan_3_1': [float('nan'), 3.0, 1.0],
                      'inf_inf_neg_inf': [float('inf'), float('inf'),
                                          -float('inf')],
                      '100_inf_1': [100.0, float('inf'), 1.0],
                      'mixed': [float('inf'), float('nan'), -float('inf'),
                                100.0, 2.0],
                      'nan_neg_inf': [float('nan'), -float('inf')]}
# one edge a lane (<= 32), one warp unrolled (33 to 128), split across the
# block (> 128)
SOFTMAX_NON_FINITE_LENGTHS = (3, 20, 77, 300, 1500)


def softmax_non_finite_inputs(rng, dev, H):
    """``(logits [E, H], row_ptr)`` on ``dev``: for each pattern of
    SOFTMAX_NON_FINITE and each length of SOFTMAX_NON_FINITE_LENGTHS a
    segment of finite logits with the pattern (its first ``length``
    values) at random places in every head, among short finite segments, an empty one, one all -inf and one
    of a finite logit among -inf."""
    import numpy as np
    import torch
    lengths, fills = [], []
    for L in SOFTMAX_NON_FINITE_LENGTHS:
        for pat in SOFTMAX_NON_FINITE.values():
            lengths += [int(rng.randint(0, 33)), L]
            fills += [None, pat]
    lengths += [0, 9, 9]
    fills += [None, 'neg_inf', 'one_finite']
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    logits = rng.randn(int(row_ptr[-1]), H).astype(np.float32) * 5
    for i, fill in enumerate(fills):
        part = logits[row_ptr[i]:row_ptr[i + 1]]
        if fill in ('neg_inf', 'one_finite'):
            part[:] = -np.inf
            if fill == 'one_finite':
                part[4] = 2.5
        elif fill is not None:
            fill = fill[:len(part)]
            for h in range(H):
                part[rng.choice(len(part), len(fill), replace=False),
                     h] = fill
    return (torch.from_numpy(logits).to(dev),
            torch.from_numpy(row_ptr).to(dev))


def softmax_non_finite_ok(y, logits, row_ptr) -> bool:
    """Whether P1's output ``y`` at non-finite ``logits`` is NaN where the
    plain version gives NaN, +0 where it gives 0, and within KERNEL_ATOL
    of it in float64 elsewhere (in float32 its sums drift on long
    segments)."""
    import torch
    from deepchem_tpu_torch.ops.csr_segment import \
        csr_segment_softmax_reference
    ref = csr_segment_softmax_reference(logits, row_ptr)
    ref64 = csr_segment_softmax_reference(logits.double(), row_ptr)
    keep, zero = ~torch.isnan(ref), ref == 0
    return torch.equal(torch.isnan(y), ~keep) \
        and max_err(y[keep].double(), ref64[keep]) <= KERNEL_ATOL \
        and same_bits(y[zero], ref[zero])


def non_finite_inputs(rng, dev):
    """Inputs on which K1-K3 have differed from the JAX package: NaN,
    infinities, signed zeros and values at or below NEG.  Returns
    ``{'table': (h, g) of K1 and K2 at F 64 and 75 on random_table's 1000
    nodes, 'pool': (x, g) of K3 at F 128 and 37, 'edges': h of K1 at F 64
    and 75 on 2400 edge rows}`` beside the shared ``table``, ``deg``,
    ``row_ptr`` and ``mask``, and the edge-id table and degrees of 1000
    nodes (``edge_table_deg``)."""
    import numpy as np
    import torch
    from deepchem_tpu_torch.ops import NEG
    table, deg = random_table(rng, 1000, dev)
    rows = {}
    for F in (64, 75):
        h = rng.randn(1000, F).astype(np.float32)
        h[0, :3] = (np.inf, -np.inf, np.nan)      # row 0: behind the pads
        h[:, 3] = -np.inf                         # nodes wholly at -inf,
        h[:, 4] = -1e16                           # below NEG,
        h[:, 5] = NEG                             # at NEG
        h[:, 6] = rng.choice([NEG, -1e16, -np.inf, np.inf], 1000)
        h[rng.rand(1000) < 0.2, 7] = np.nan
        h[:, 8] = np.where(rng.rand(1000) < 0.5, -0.0, 0.0)
        h[0, 8] = -0.0                            # -0 behind the pads
        h[:, 9] = -0.0                            # sums of -0 only
        h[:, 10] = 0.0                            # node 0 (degree 10, the
        h[0, 10] = 100.0                          # table's K) wins every max
        g = rng.randn(1000, F).astype(np.float32)
        g[0, 0], g[1, 1], g[rng.rand(1000) < 0.1, 2] = np.inf, np.nan, -np.inf
        g[:, 3] = -0.0                            # K2's backward: +0
        g[rng.rand(1000) < 0.3, 9] = -0.0
        g[:, 10] = -0.0                           # K2's backward: -0 at node 0
        rows[F] = tuple(torch.from_numpy(a).to(dev) for a in (h, g))
    # graphs of 3, 5, 0, 1, 40, 0 and 17 rows, 2 empty slots, a ghost tail
    # of 20 rows; row 4 (graph 1) masked
    sizes = [3, 5, 0, 1, 40, 0, 17]
    G, N = len(sizes) + 2, sum(sizes) + 20
    row_ptr = torch.tensor(np.concatenate([[0], np.cumsum(sizes + [0, 0])]),
                           dtype=torch.int32, device=dev)
    mask = (torch.arange(N, device=dev) < sum(sizes)).float()
    mask[4] = 0.0
    pool = {}
    for F in (128, 37):
        x = rng.randint(-3, 3, (N, F)).astype(np.float32)
        x[1, 0] = -np.inf            # graph 0: a valid -inf row
        x[5, 1] = np.nan             # graph 1: a valid NaN row
        x[4, 2] = np.nan             # graph 1: the masked row NaN
        x[4, 3] = np.inf             # graph 1: the masked row +inf
        x[10, 4] = np.inf            # graph 4: a +inf max
        x[11, 5], x[12, 5] = np.inf, -np.inf
        x[:, 6] = np.where(rng.rand(N) < 0.5, -0.0, 0.0)  # signed zero ties
        x[:, 7] = NEG                # every row at NEG
        x[:, 8] = -1e16              # every row below NEG
        x[-1, 9] = np.nan            # a ghost row
        g = rng.randn(G, F).astype(np.float32)
        g[0, 10], g[1, 11], g[2, 12], g[4, 13] = (np.inf, np.nan, np.inf,
                                                  -np.inf)
        g[:, 14] = -0.0              # -0 times the selection
        pool[F] = tuple(torch.from_numpy(a).to(dev) for a in (x, g))
    # K1 from 2400 edge rows into 1000 nodes (MPNN's edge-id tables),
    # from a generator of their own
    erng = np.random.RandomState(12)
    edges = {}
    for F in (64, 75):
        h = erng.randn(2400, F).astype(np.float32)
        h[0, :3] = (np.inf, -np.inf, np.nan)      # edge 0: behind the pads
        h[erng.rand(2400) < 0.1, 3] = np.nan
        h[erng.rand(2400) < 0.1, 4] = np.inf
        h[:, 5] = np.where(erng.rand(2400) < 0.5, -0.0, 0.0)
        h[:, 6] = -0.0                            # sums of -0 only
        edges[F] = torch.from_numpy(h).to(dev)
    return {'table': rows, 'pool': pool, 'table_deg': (table, deg),
            'row_ptr': row_ptr, 'mask': mask, 'edges': edges,
            'edge_table_deg': random_edge_table(erng, 1000, 2400, dev)}


def non_finite_cases(rng, dev):
    """K1, K2 and K3, forward and backward, at :func:`non_finite_inputs`,
    each kernel on both of its paths where it has two, held for exact
    equality with the plain versions, signs of zeros included
    (:func:`same_bits`; K2's winners equal; K3's internal mx, which the
    backward only compares with >=, as values); K1 also from edge rows
    through an edge-id table.  Then P1 at
    :func:`softmax_non_finite_inputs`, H 1 and 3, on its three paths
    (:func:`softmax_non_finite_ok`).  Returns a result for each case."""
    import torch
    from deepchem_tpu_torch.ops import nei_table, segment
    from deepchem_tpu_torch.ops.csr_segment import _softmax_forward
    inp = non_finite_inputs(rng, dev)
    table, deg = inp['table_deg']
    results = []
    for F, (h, g) in inp['table'].items():
        for tag, place in (('', lambda t: t), ('_misaligned', misaligned)):
            h_, g_ = place(h), place(g)
            out = nei_table._nei_sum_forward(h_, table, deg,
                                             nei_table.nei_sum)
            grad = nei_table._nei_sum_forward(g_, table, deg,
                                              nei_table.nei_sum,
                                              'backward_launches')
            best, win = nei_table._nei_max_forward(h_, table, deg)
            gmax = nei_table._nei_max_backward(g_, table, deg, win)
            torch.cuda.synchronize()
            ref_best, ref_win = nei_table.nei_max_reference(h, table, deg)
            res = {'case': f'non_finite_F{F}{tag}', 'checks': {
                'nei_sum': same_bits(
                    out, nei_table.nei_sum_reference(h, table, deg)),
                'nei_sum_bwd': same_bits(
                    grad, nei_table.nei_sum_reference(g, table, deg)),
                'nei_max_fwd': same_bits(best, ref_best)
                and torch.equal(win, ref_win),
                'nei_max_bwd': same_bits(
                    gmax, nei_table.nei_max_backward_reference(
                        g, table, deg, ref_win))},
                'nan_outputs': int(torch.isnan(out).sum()
                                   + torch.isnan(best).sum())}
            results.append(res)
    e_table, e_deg = inp['edge_table_deg']
    for F, h in inp['edges'].items():
        for tag, place in (('', lambda t: t), ('_misaligned', misaligned)):
            out = nei_table._nei_sum_forward(place(h), e_table, e_deg,
                                             nei_table.nei_sum)
            torch.cuda.synchronize()
            results.append({'case': f'non_finite_edges_F{F}{tag}', 'checks': {
                'nei_sum_edges': same_bits(out, nei_table.nei_sum_reference(
                    h, e_table, e_deg))},
                'nan_outputs': int(torch.isnan(out).sum())})
    row_ptr, mask = inp['row_ptr'], inp['mask']
    for F, (x, g) in inp['pool'].items():
        for tag, place in (('', lambda t: t), ('_misaligned', misaligned)):
            x_ = place(x)
            out, mx, den = segment._graph_max_forward(x_, row_ptr, mask)
            dx = segment._graph_max_backward(g, x_, row_ptr, mask, mx, den)
            torch.cuda.synchronize()
            ref, ref_mx, ref_den = segment.graph_max_pool_reference(
                x, row_ptr, mask)
            ref_dx = segment.graph_max_pool_backward_reference(
                g, x, row_ptr, mask, ref_mx, ref_den)
            results.append({'case': f'non_finite_pool_F{F}{tag}', 'checks': {
                'graph_max_pool_fwd': same_bits(out, ref)
                and same_values(mx, ref_mx) and torch.equal(den, ref_den),
                'graph_max_pool_bwd': same_bits(dx, ref_dx)},
                'nan_outputs': int(torch.isnan(out).sum()
                                   + torch.isnan(dx).sum())})
    for H in (1, 3):
        logits, row_ptr = softmax_non_finite_inputs(rng, dev, H)
        y = _softmax_forward(logits, row_ptr)
        torch.cuda.synchronize()
        results.append({'case': f'non_finite_softmax_H{H}', 'checks': {
            'csr_segment_softmax': softmax_non_finite_ok(y, logits,
                                                         row_ptr)},
            'nan_outputs': int(torch.isnan(y).sum())})
    for res in results:
        print(f'phase 3 non-finite {json.dumps(res)}', flush=True)
        for kname, ok in res['checks'].items():
            check(ok, f'{res["case"]}: {kname} differs from its plain '
                  'version')
    return results


def library_attention(q, k, v, scale):
    """P4's forward as one library call, for comparison only: SDPA with
    its flash backend in bfloat16 and its memory-efficient backend in
    float32 (the flash backend takes no float32)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    backend = SDPBackend.FLASH_ATTENTION if q.dtype == torch.bfloat16 \
        else SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel(backend):
        return F.scaled_dot_product_attention(q, k, v, scale=scale)


def flash_case(name, shape, dtype, dev, iters=200, seed=0):
    """P4's forward, dK/dV and dQ kernels against the plain versions on the
    card, with times and bounds: one result for each kernel.  The plain
    versions run on the first 2 batch rows from S = PLAIN_ROWS_FROM_S on (a
    [16, 12, 4096, 4096] float32 score array is 12.9 GB)."""
    import torch
    from deepchem_tpu_torch.ops.flash_attention import (
        _forward_reference, flash_attention, flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_reference, flash_attention_bwd_dq,
        flash_attention_bwd_dq_reference, flash_attention_forward,
        flash_attention_reference)
    B, H, S, D = shape
    gen = torch.Generator(dev).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(4))
    scale = D ** -0.5

    def run():
        o, m, l = flash_attention_forward(q, k, v, scale)
        di = (o.float() * do.float()).sum(-1)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, m, l, di, scale)
        return (o, dk, dv, flash_attention_bwd_dq(q, k, v, do, m, l, di,
                                                  scale)), (m, l, di)
    outs, stats = run()
    again, again_st = run()
    torch.cuda.synchronize()
    o, (m, l) = outs[0], stats[:2]
    rows = 2 if S >= PLAIN_ROWS_FROM_S else B
    ref_in = [t[:rows].float().requires_grad_() for t in (q, k, v)]
    ref_o = flash_attention_reference(*ref_in, scale)
    ref_o.backward(do[:rows].float())
    kind = str(dtype).split('.')[-1]
    fwd_tol, grad_tol = FLASH_TOL[kind]

    def error(pairs, rtol):
        err = max(max_err(a[:rows].float(), r) for a, r in pairs)
        return err, rtol * max(1.0, max(r.abs().max().item()
                                        for _, r in pairs))

    def rel_error(pairs):
        return max(max_err(a[:rows].float(), r) / r.abs().max().item()
                   for a, r in pairs)
    dk, dv, dq = outs[1:]
    pairs = {'fwd': [(o, ref_o.detach())],
             'dkv': [(dk, ref_in[1].grad), (dv, ref_in[2].grad)],
             'dq': [(dq, ref_in[0].grad)]}
    errs = {part: error(p, grad_tol if part != 'fwd' else fwd_tol)
            for part, p in pairs.items()}
    rel = {part: rel_error(p) for part, p in pairs.items()}
    # the forward's statistics, which the backward reads, row by row
    _, ref_m, ref_l = _forward_reference(*(t[:rows] for t in (q, k, v)),
                                         scale)
    stat_err = max(((a[:rows] - r).abs() / r.abs().clamp_min(1.0)).max()
                   .item() for a, r in ((m, ref_m), (l, ref_l)))
    del ref_m, ref_l
    exact = {}
    if dtype == torch.float32:
        # o and the gradients against the plain version in float64, beside
        # the float32 plain version's own errors, each of max(1, |ref|):
        # where the two float32 results part, which is nearer the exact
        # one (recorded, not checked)
        in64 = [t[:rows].double().requires_grad_() for t in (q, k, v)]
        ref64 = torch.softmax(in64[0] @ in64[1].transpose(-1, -2) * scale,
                              dim=-1) @ in64[2]
        ref64.backward(do[:rows].double())
        got = {'fwd': [(o, ref_o.detach(), ref64.detach())],
               'dkv': [(dk, ref_in[1].grad, in64[1].grad),
                       (dv, ref_in[2].grad, in64[2].grad)],
               'dq': [(dq, ref_in[0].grad, in64[0].grad)]}

        def err64(pairs):
            return max(max_err(a.double(), r) / max(1.0, r.abs().max().item())
                       for a, r in pairs)
        exact = {part: {'err_f64': err64((a[:rows], r) for a, _, r in t),
                        'plain_err_f64': err64((p, r) for _, p, r in t)}
                 for part, t in got.items()}
        del in64, ref64, got
    same = {'fwd': torch.equal(o, again[0]) and torch.equal(m, again_st[0])
            and torch.equal(l, again_st[1]),
            'dkv': torch.equal(dk, again[1]) and torch.equal(dv, again[2]),
            'dq': torch.equal(dq, again[3])}
    del ref_in, ref_o, pairs, again
    # the library call: SDPA's forward, and its backward alone
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    lib_o = library_attention(lq, lk, lv, scale)
    lib_err = max_err(lib_o[:rows].detach().float(),
                      flash_attention_reference(
                          *(t[:rows] for t in (q, k, v)), scale).float())
    lib_fwd_ms = time_ms(lambda: library_attention(q, k, v, scale), iters)
    # device time of whole calls: SDPA's forward, SDPA's backward (dQ, dK
    # and dV), and the port's backward through its autograd Function (di,
    # then the dK/dV and dQ kernels)
    lib_fwd_dev = device_us_all(lambda: library_attention(q, k, v, scale))
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        lib_o, (lq, lk, lv), do, retain_graph=True)
    lib_bwd_ms = time_ms(lib_bwd, iters)
    lib_bwd_dev = device_us_all(lib_bwd)
    pq, pk, pv = (t.detach().requires_grad_() for t in (q, k, v))
    port_o = flash_attention(pq, pk, pv, scale)
    port_bwd_dev = device_us_all(lambda: torch.autograd.grad(
        port_o, (pq, pk, pv), do, retain_graph=True))
    del port_o, lib_o
    di = stats[2]
    small = [t[:rows] for t in (q, k, v, do, m, l, di)]
    fns = {'fwd': (lambda: flash_attention_forward(q, k, v, scale),
                   lambda: flash_attention_reference(*small[:3], scale)),
           'dkv': (lambda: flash_attention_bwd_dkv(q, k, v, do, m, l, di,
                                                   scale),
                   lambda: flash_attention_bwd_dkv_reference(*small, scale)),
           'dq': (lambda: flash_attention_bwd_dq(q, k, v, do, m, l, di,
                                                 scale),
                  lambda: flash_attention_bwd_dq_reference(*small, scale))}
    # bytes: each input read once, each output written once; operations:
    # the products of S x S by D each kernel has to do (4, 8 and 6 flops a
    # score: q k^T and p v; s and dp again, dV and dK; s, dp and dQ), at
    # the rate of the unit that runs them: the tensor cores, in bf16, or
    # in f32 by three tf32 passes
    esize, bhsd, bhs = q.element_size(), B * H * S * D, B * H * S
    bf16 = dtype == torch.bfloat16
    rate = BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S / TF32_PASSES
    work = {'fwd': (4 * bhsd * esize + 2 * bhs * 4, 4 * bhs * S * D, rate),
            'dkv': (6 * bhsd * esize + 3 * bhs * 4, 8 * bhs * S * D, rate),
            'dq': (5 * bhsd * esize + 3 * bhs * 4, 6 * bhs * S * D, rate)}
    results = {}
    for part, (fn, plain) in fns.items():
        bound_ms, bound_by = bound(*work[part])
        res = {'kernel': f'flash_attention_{part}', 'case': name,
               'shape': list(shape), 'dtype': kind,
               'max_abs_err': errs[part][0], 'tol': errs[part][1],
               'repeat_identical': same[part],
               'ms': time_ms(fn, iters),
               'device_us': device_us(fn, f'flash_{part}_', bound_ms * 1e3),
               'plain_ms': time_ms(plain, iters), 'plain_rows': rows,
               'library_ms': lib_fwd_ms if part == 'fwd' else lib_bwd_ms,
               'bound_ms': bound_ms, 'bound_by': bound_by}
        res['bound_share'] = bound_ms * 1e3 / res['device_us']
        if bf16:
            res['rel_err'] = rel[part]
            res['rel_tol'] = FLASH_FWD_RTOL if part == 'fwd' \
                else FLASH_GRAD_RTOL
        lib_dev = lib_fwd_dev if part == 'fwd' else lib_bwd_dev
        res['library_device_us'], res['library_kernels'] = lib_dev
        res.update(exact.get(part, {}))
        if part == 'fwd':
            res['library_err'] = lib_err
            res['stat_err'], res['stat_tol'] = stat_err, STAT_RTOL
        else:
            res['library'] = 'SDPA backward: dQ, dK and dV in one call'
            res['backward_device_us'], res['backward_kernels'] = port_bwd_dev
        print(f'phase 6 kernel {json.dumps(res)}', flush=True)
        check(res['max_abs_err'] <= res['tol'],
              f'{name} {part}: error {res["max_abs_err"]} > {res["tol"]}')
        check(res.get('rel_err', 0.0) <= res.get('rel_tol', 0.0),
              f'{name} {part}: error {res.get("rel_err")} of max |ref| > '
              f'{res.get("rel_tol")}')
        check(res.get('stat_err', 0.0) <= STAT_RTOL,
              f'{name} {part}: m or l off by {res.get("stat_err")} of '
              f'max(1, |ref|)')
        check(same[part], f'{name} {part}: a repeat differs')
        results[part] = res
    return results


@contextlib.contextmanager
def flash_routed():
    """The encoder's attention through P4: the module-level
    ``flash_or_xla_attention`` swapped for one that passes
    ``use_flash=True``, as scripts/mfu_ablation.py swaps attention in the
    JAX package."""
    from deepchem_tpu_torch.models import bert_encoder
    einsum = bert_encoder.flash_or_xla_attention

    def flash(q, k, v, mask, use_flash=None):
        return einsum(q, k, v, mask, use_flash=True)
    bert_encoder.flash_or_xla_attention = flash
    try:
        yield
    finally:
        bert_encoder.flash_or_xla_attention = einsum


def mlm_batch(tok, smiles, seed):
    """Token ids padded to SEQ, the attention mask, and an MLM input with
    15 % of the real tokens replaced by [MASK]; the labels are the ids."""
    import numpy as np
    import torch
    ids = torch.tensor([tok.encode(s, max_length=SEQ) for s in smiles])
    mask = (ids != tok.pad_token_id).float()
    pick = torch.from_numpy(np.random.RandomState(seed).rand(*ids.shape)
                            < 0.15) & (mask > 0)
    return ids, mask, torch.where(pick, tok.mask_token_id, ids)


def encoder_step(model, inputs, labels, label_mask, mask=None):
    """Forward, MLM loss on the real tokens, backward: the logits, the loss
    and a copy of every parameter's gradient."""
    from deepchem_tpu_torch.models import mlm_loss
    model.zero_grad(set_to_none=True)
    logits = model(inputs, mask)
    loss = mlm_loss(logits, labels, label_mask)
    loss.backward()
    return logits.detach(), loss.detach(), {
        n: p.grad.detach().clone() for n, p in model.named_parameters()}


def scaled_err(a, b) -> float:
    """max |a - b| / max(1, max |b|)."""
    return max_err(a.float(), b.float()) / max(1.0, b.abs().max().item())


def recorded(module, attr, run):
    """Run ``run()`` with ``module.attr`` wrapped to record copies of its
    arguments; return them."""
    import torch
    fn, seen = getattr(module, attr), []

    def record(*args, **kwargs):
        seen.append(tuple(a.detach().clone() if isinstance(a, torch.Tensor)
                          else a for a in args))
        return fn(*args, **kwargs)

    # a wrapper counts its launches through its module's name for it, so
    # the stand-in shares the wrapper's attributes (``launches``)
    record.__dict__ = fn.__dict__
    setattr(module, attr, record)
    try:
        run()
    finally:
        setattr(module, attr, fn)
    return seen


def bench_graph(rng, n_nodes, n_edges, feat, dev):
    """scripts/bench_pallas_csr.py's graph: random src and dst, sorted by
    dst; h uniform in [0, 1)."""
    import numpy as np
    import torch
    from deepchem_tpu_torch.ops import edges_to_csr
    src = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    perm, row_ptr = edges_to_csr(dst, n_nodes)
    h = rng.rand(n_nodes, feat).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (h, src[perm], row_ptr)]


def p2_long_inputs(dev):
    """P2's synthetic long-segment inputs, {name: (h, src, row_ptr)}, from
    a generator of their own: ``p2_hub_2000_F64``, 2048 nodes with 0 to 3
    in-edges each from random rows, but node 1000 with P2_HUB_EDGES;
    ``p2_long_segment_4096_F300``, edge rows ``[E, 300]`` summed by
    destination (each edge its own row, in a random order), 2047 nodes
    with 0 to 2 edges and the last with P2_LONG_EDGES."""
    import numpy as np
    import torch
    rng = np.random.RandomState(17)
    hub = rng.randint(0, 4, 2048)
    hub[1000] = P2_HUB_EDGES
    long_ = np.append(rng.randint(0, 3, 2047), P2_LONG_EDGES)
    out = {}
    for name, deg, F in (('p2_hub_2000_F64', hub, 64),
                         ('p2_long_segment_4096_F300', long_, 300)):
        row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
        E = int(row_ptr[-1])
        rows = 2048 if F == 64 else E
        src = (rng.randint(0, rows, E) if F == 64
               else rng.permutation(E)).astype(np.int32)
        h = rng.randn(rows, F).astype(np.float32)
        out[name] = tuple(torch.from_numpy(a).to(dev)
                          for a in (h, src, row_ptr))
    return out


def _counted():
    """Each kernel's launch counter: the wrapper and its attribute."""
    from deepchem_tpu_torch.ops import (csr_segment_softmax, csr_segment_sum,
                                        flash_attention,
                                        flash_attention_bwd_dkv,
                                        flash_attention_bwd_dq,
                                        fused_gather_segment_sum,
                                        graph_max_pool, nei_gather,
                                        nei_max_incl_self, nei_sum,
                                        nei_sum_edges, take_src)
    from deepchem_tpu_torch.models import grover
    return {'csr_segment_softmax': (csr_segment_softmax, 'launches'),
            'csr_segment_sum': (csr_segment_sum, 'launches'),
            'fused_gather_segment_sum': (fused_gather_segment_sum,
                                         'launches'),
            'fused_gather_segment_sum_bwd': (fused_gather_segment_sum,
                                             'backward_launches'),
            'fused_gather_segment_sum_bf16': (fused_gather_segment_sum,
                                              'bf16_launches'),
            'flash_attention_fwd': (flash_attention, 'launches'),
            'flash_attention_dkv': (flash_attention_bwd_dkv, 'launches'),
            'flash_attention_dq': (flash_attention_bwd_dq, 'launches'),
            'nei_sum': (nei_sum, 'launches'),
            'nei_sum_bwd': (nei_sum, 'backward_launches'),
            'nei_sum_edges': (nei_sum_edges, 'launches'),
            'take_src_bwd': (take_src, 'backward_launches'),
            'nei_gather': (nei_gather, 'launches'),
            'nei_gather_bwd': (nei_gather, 'backward_launches'),
            'nei_max_fwd': (nei_max_incl_self, 'launches'),
            'nei_max_bwd': (nei_max_incl_self, 'backward_launches'),
            'graph_max_pool_fwd': (graph_max_pool, 'launches'),
            'graph_max_pool_bwd': (graph_max_pool, 'backward_launches'),
            'grover_nei_sum_sym': (grover.nei_sum_sym, 'launches'),
            'grover_nei_sum_sym_bwd': (grover.nei_sum_sym,
                                       'backward_launches'),
            'grover_nei_sum_sym_g': (grover.nei_sum_sym_g, 'launches'),
            'grover_nei_sum_sym_g_bwd': (grover.nei_sum_sym_g,
                                         'backward_launches'),
            'grover_nei_sum_bonds': (grover.nei_sum_bonds, 'launches'),
            'grover_nei_sum_bonds_g': (grover.nei_sum_bonds_g, 'launches'),
            'grover_slot_sum': (grover.slot_sum, 'launches')}


def launch_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in _counted().items()}


def reset_launch_counts():
    for fn, attr in _counted().values():
        setattr(fn, attr, 0)


def graphconv_data():
    """The 48 SMILES featurized for GraphConvModel, repeated and shuffled
    from a seed to GRAPHCONV_MOLECULES, with seeded 0/1 labels for its 12
    tasks."""
    import numpy as np
    from deepchem_tpu_torch import ConvMolFeaturizer
    X48 = ConvMolFeaturizer().featurize(SMILES)
    check(all(hasattr(g, 'num_nodes') for g in X48),
          'every molecule featurizes for GraphConv')
    reps = GRAPHCONV_MOLECULES // len(SMILES)
    order = np.random.RandomState(0).permutation(
        np.tile(np.arange(len(SMILES)), reps))
    labels = np.random.RandomState(1).randint(
        0, 2, (len(order), GRAPHCONV['n_tasks'])).astype(np.float32)
    return X48[order], labels


def mpnn_data():
    """The 48 SMILES and STEREO_SMILES featurized for MPNNModel
    (MolGraphConvFeaturizer with bond features), repeated and shuffled
    from a seed to MPNN_MOLECULES, with seeded normal labels."""
    import numpy as np
    from deepchem_tpu_torch import MolGraphConvFeaturizer
    smiles = SMILES + STEREO_SMILES
    X = MolGraphConvFeaturizer(use_edges=True).featurize(smiles)
    check(all(hasattr(g, 'num_nodes') for g in X),
          'every molecule featurizes for MPNN')
    order = np.random.RandomState(0).permutation(
        np.resize(np.arange(len(smiles)), MPNN_MOLECULES))
    labels = np.random.RandomState(1).randn(MPNN_MOLECULES, 1)
    return X[order], labels.astype(np.float32)


def batch_draw(n, batch, batches):
    """``batches`` index arrays of ``batch`` of ``n`` molecules drawn with
    replacement (RandomState(0)): the requests and the epoch of
    scripts/profile_torch_pagtn.py."""
    import numpy as np
    rng = np.random.RandomState(0)
    return [rng.randint(0, n, batch) for _ in range(batches)]


def dmpnn_coo_fit_p2_inputs(dev):
    """P2's arguments in one ``fit`` epoch of DMPNN on its COO branch over
    FIT_DRAW_BATCHES batches of 100 molecules drawn from SMILES +
    STEREO_SMILES (:func:`batch_draw`), each padded to the epoch's caps:
    the shapes the training path hands P2, ghost range and all."""
    import numpy as np
    from deepchem_tpu_torch import DMPNNFeaturizer, DMPNNModel, NumpyDataset
    from deepchem_tpu_torch.ops import csr_segment
    X = DMPNNFeaturizer().featurize(SMILES + STEREO_SMILES)
    idx = np.concatenate(batch_draw(len(X), 100, FIT_DRAW_BATCHES))
    y = np.random.RandomState(0).randn(len(idx), 1).astype(np.float32)
    with coo_branch(DMPNNModel):
        model = DMPNNModel(**DMPNN, batch_size=100, device=dev, seed=0)
        return recorded(csr_segment, '_gather_sum_forward',
                        lambda: model.fit(NumpyDataset(X[idx], y),
                                          nb_epoch=1))


def table_data(featurizer, smiles):
    """``smiles`` featurized by ``featurizer``, repeated and shuffled from a
    seed to TABLE_MOLECULES, with seeded normal labels."""
    import numpy as np
    X = featurizer.featurize(smiles)
    check(all(hasattr(g, 'num_nodes') for g in X),
          f'every molecule featurizes with {type(featurizer).__name__}')
    order = np.random.RandomState(0).permutation(
        np.resize(np.arange(len(smiles)), TABLE_MOLECULES))
    labels = np.random.RandomState(1).randn(TABLE_MOLECULES, 1)
    return X[order], labels.astype(np.float32)


def weave_data():
    """Phase 11's molecules (the 48 SMILES in graphconv_data's order and
    labels) as WeaveFeaturizer graphs, the rows of each SMILES's first
    copy (the scored set: a ranking score breaks ties of equal molecules by
    the last bit, which differs between batches of A 32 and A 48), and the
    molecules of at most 32 atoms (every batch packs to A 32: the set
    ``fit_on_device`` can stack)."""
    import numpy as np
    from deepchem_tpu_torch import WeaveFeaturizer
    X48 = WeaveFeaturizer().featurize(SMILES)
    check(all(hasattr(g, 'pair_features') for g in X48),
          'every molecule featurizes for Weave')
    reps = GRAPHCONV_MOLECULES // len(SMILES)
    order = np.random.RandomState(0).permutation(
        np.tile(np.arange(len(SMILES)), reps))
    labels = np.random.RandomState(1).randint(
        0, 2, (len(order), WEAVE['n_tasks'])).astype(np.float32)
    X = X48[order]
    first = np.unique(order, return_index=True)[1]
    small = np.array([g.num_nodes <= 32 for g in X])
    return X, labels, first, (X[small], labels[small])


def dag_data():
    """Phase 13's molecules and labels as ConvMolFeaturizer graphs with
    DAGTransformer(max_atoms=50)'s depth tables."""
    from deepchem_tpu_torch import ConvMolFeaturizer, DAGTransformer
    X, y = table_data(ConvMolFeaturizer(), SMILES)
    X = DAGTransformer(max_atoms=DAG['max_atoms']).transform_array(
        X, None, None, None)[0]
    return X, y


def coulomb_data():
    """The SMILES of at most QM7_ATOMS heavy atoms, embedded in 3D by
    ConformerGenerator(seed=0), as CoulombMatrix(max_atoms=QM7_ATOMS)
    (timed a molecule), repeated and shuffled from a seed to
    COULOMB_MOLECULES, with seeded normal labels."""
    import numpy as np
    from deepchem_tpu_torch import CoulombMatrix
    from deepchem_tpu_torch.chem import mol_from_smiles
    from deepchem_tpu_torch.utils.conformers import ConformerGenerator
    mols = [m for m in map(mol_from_smiles, SMILES)
            if m.num_atoms <= QM7_ATOMS]
    gen = ConformerGenerator(seed=0)
    t0 = time.perf_counter()
    mols = [gen.generate_conformers(m) for m in mols]
    X = CoulombMatrix(max_atoms=QM7_ATOMS).featurize(mols)
    per_mol_ms = (time.perf_counter() - t0) * 1e3 / len(mols)
    check(X.shape == (len(mols), QM7_ATOMS, QM7_ATOMS)
          and bool(np.isfinite(X).all()),
          'every molecule of at most 23 atoms has a Coulomb matrix')
    order = np.random.RandomState(0).permutation(
        np.resize(np.arange(len(mols)), COULOMB_MOLECULES))
    labels = np.random.RandomState(1).randn(COULOMB_MOLECULES, 1)
    return X[order], labels.astype(np.float32), len(mols), per_mol_ms


def _cubic_cell(a, species, frac):
    return {'lattice': [[a, 0, 0], [0, a, 0], [0, 0, a]],
            'species': list(species), 'frac_coords': [list(f) for f in frac]}


_FCC = [(0, 0, 0), (0, .5, .5), (.5, 0, .5), (.5, .5, 0)]
_FCC_QUARTER = [(x + .25, y + .25, z + .25) for x, y, z in _FCC]
# ten prototype crystals (experimental lattice constants, Å): rock salt
# NaCl and MgO, CsCl, diamond Si, zinc-blende GaAs, fcc Cu, bcc Fe, cubic
# perovskite SrTiO3, rutile TiO2 (u 0.305), wurtzite ZnO (u 0.382)
CRYSTALS = {
    'NaCl': _cubic_cell(5.64, ['Na'] * 4 + ['Cl'] * 4, _FCC + [
        (.5, 0, 0), (0, .5, 0), (0, 0, .5), (.5, .5, .5)]),
    'MgO': _cubic_cell(4.212, ['Mg'] * 4 + ['O'] * 4, _FCC + [
        (.5, 0, 0), (0, .5, 0), (0, 0, .5), (.5, .5, .5)]),
    'CsCl': _cubic_cell(4.12, ['Cs', 'Cl'], [(0, 0, 0), (.5, .5, .5)]),
    'Si': _cubic_cell(5.431, ['Si'] * 8, _FCC + _FCC_QUARTER),
    'GaAs': _cubic_cell(5.653, ['Ga'] * 4 + ['As'] * 4,
                        _FCC + _FCC_QUARTER),
    'Cu': _cubic_cell(3.615, ['Cu'] * 4, _FCC),
    'Fe': _cubic_cell(2.87, ['Fe'] * 2, [(0, 0, 0), (.5, .5, .5)]),
    'SrTiO3': _cubic_cell(3.905, ['Sr', 'Ti', 'O', 'O', 'O'], [
        (0, 0, 0), (.5, .5, .5), (.5, .5, 0), (.5, 0, .5), (0, .5, .5)]),
    'TiO2': {'lattice': [[4.594, 0, 0], [0, 4.594, 0], [0, 0, 2.959]],
             'species': ['Ti', 'Ti', 'O', 'O', 'O', 'O'],
             'frac_coords': [(0, 0, 0), (.5, .5, .5), (.305, .305, 0),
                             (.695, .695, 0), (.805, .195, .5),
                             (.195, .805, .5)]},
    'ZnO': {'lattice': [[3.25, 0, 0], [-1.625, 2.8145825622994254, 0],
                        [0, 0, 5.21]],
            'species': ['Zn', 'Zn', 'O', 'O'],
            'frac_coords': [(1 / 3, 2 / 3, 0), (2 / 3, 1 / 3, .5),
                            (1 / 3, 2 / 3, .382), (2 / 3, 1 / 3, .882)]},
}


def supercell(s, n=2):
    """The ``n x n x n`` supercell of a structure dict."""
    import itertools
    shifts = list(itertools.product(range(n), repeat=3))
    return {'lattice': [[n * v for v in row] for row in s['lattice']],
            'species': [e for _ in shifts for e in s['species']],
            'frac_coords': [tuple((f[k] + sh[k]) / n for k in range(3))
                            for sh in shifts for f in s['frac_coords']]}


def formula(s):
    """``'Na4Cl4'``: each species and its count, in order of first
    appearance."""
    from collections import Counter
    return ''.join(f'{e}{c}' for e, c in Counter(s['species']).items())


def materials_data():
    """Phase 20's inputs.  The ten CRYSTALS and their 2x2x2 supercells (2
    to 64 atoms), repeated and shuffled from a seed to CRYSTAL_COUNT, with
    seeded normal labels, one a structure, featurized by CGCNNFeaturizer(),
    LCNNFeaturizer(), ElemNetFeaturizer (of their formulas),
    SineCoulombMatrix() and ElementPropertyFingerprint() (both z-scored by
    NormalizationTransformer), each timed a structure; and the 48 SMILES
    shuffled to CONFORMER_MOLECULES as RDKitConformerFeaturizer graphs,
    embedded by the port's conformer code, with seeded labels, one a
    molecule."""
    import numpy as np
    from deepchem_tpu_torch import (CGCNNFeaturizer, ElemNetFeaturizer,
                                    ElementPropertyFingerprint,
                                    LCNNFeaturizer, NumpyDataset,
                                    RDKitConformerFeaturizer,
                                    SineCoulombMatrix)
    from deepchem_tpu_torch.trans import NormalizationTransformer
    structs = list(CRYSTALS.values())
    structs += [supercell(s) for s in structs]
    sizes = [len(s['species']) for s in structs]
    check(min(sizes) == 2 and max(sizes) == 64, 'cells of 2 to 64 atoms')
    order = np.random.RandomState(0).permutation(
        np.resize(np.arange(len(structs)), CRYSTAL_COUNT))
    y = np.random.RandomState(1).randn(len(structs), 1).astype(
        np.float32)[order]
    out, ms = {'y': y, 'sizes': sizes}, {}
    for key, feat, data in (
            ('cgcnn', CGCNNFeaturizer(), structs),
            ('lcnn', LCNNFeaturizer(), structs),
            ('elemnet', ElemNetFeaturizer(), [formula(s) for s in structs]),
            ('sine_coulomb', SineCoulombMatrix(), structs),
            ('element_property', ElementPropertyFingerprint(),
             [formula(s) for s in structs])):
        t0 = time.perf_counter()
        X = feat.featurize(data)
        ms[key] = (time.perf_counter() - t0) * 1e3 / len(data)
        check(len(X) == len(structs) and all(
            getattr(x, 'num_nodes', None) or np.size(x) for x in X),
              f'every structure featurizes with {type(feat).__name__}')
        X = X[order]
        if key in ('sine_coulomb', 'element_property'):
            tx = NormalizationTransformer(transform_X=True,
                                          dataset=NumpyDataset(X, y))
            X = tx.transform_array(X, y, None, None)[0].astype(np.float32)
        out[key] = X
    edges = [g.num_edges for g in out['cgcnn']]
    t0 = time.perf_counter()
    X48 = RDKitConformerFeaturizer().featurize(SMILES)
    ms['conformer'] = (time.perf_counter() - t0) * 1e3 / len(SMILES)
    check(all(g.node_pos_features.shape == (g.num_nodes, 3) for g in X48),
          'every molecule embeds in 3D')
    mol_order = np.random.RandomState(0).permutation(
        np.resize(np.arange(len(SMILES)), CONFORMER_MOLECULES))
    out['conformer'] = X48[mol_order]
    out['conformer_y'] = np.random.RandomState(1).randn(
        len(SMILES), 1).astype(np.float32)[mol_order]
    out['featurize_ms'] = ms
    out['edges_per_atom'] = sum(edges) / sum(g.num_nodes
                                             for g in out['cgcnn'])
    return out


# elements of the written complexes (all in AtomicConvModel's types but Se,
# which is read as -1), carbon most often
COMPLEX_ELEMENTS = ['C'] * 6 + ['N', 'N', 'O', 'O', 'S', 'P', 'Cl', 'Zn',
                                'Se']


def complex_pdb(rng, n, radius, record):
    """``n`` atoms as PDB records, uniform in a ball of ``radius`` Å about
    the origin, elements drawn from COMPLEX_ELEMENTS."""
    import numpy as np
    xyz = rng.randn(n, 3)
    xyz *= (radius * rng.rand(n, 1) ** (1 / 3)
            / np.linalg.norm(xyz, axis=1, keepdims=True))
    elems = [COMPLEX_ELEMENTS[k]
             for k in rng.randint(0, len(COMPLEX_ELEMENTS), n)]
    return [f'{record:<6}{i + 1:5d} {e.upper():<4} LIG A   1    '
            f'{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {e:>2}\n'
            for i, ((x, y, z), e) in enumerate(zip(xyz, elems))]


def slice21_data():
    """Phase 21's inputs: the 48 SMILES as MXMNetFeaturizer graphs,
    shuffled to MXMNET_MOLECULES with seeded labels; ATOMIC_COMPLEXES
    complexes written as PDB text (a ligand of LIGAND_ATOMS heavy atoms in
    a 6 Å ball, a pocket of POCKET_ATOMS in a 14 Å ball about it) and
    featurized by AtomicConvFeaturizer(), seeded labels; the 48 SMILES as
    MolGraphConvFeaturizer graphs shuffled to FEWSHOT_MOLECULES with
    seeded 0/1 labels for FEWSHOT_TASKS tasks; the first EGNN_GRAPHS as
    EquivariantGraphFeaturizer graphs.  Each featurizer timed a
    molecule or complex."""
    import numpy as np
    from deepchem_tpu_torch import (AtomicConvFeaturizer,
                                    EquivariantGraphFeaturizer,
                                    MolGraphConvFeaturizer, MXMNetFeaturizer)
    out, ms = {}, {}
    t0 = time.perf_counter()
    X = MXMNetFeaturizer().featurize(SMILES)
    ms['mxmnet'] = (time.perf_counter() - t0) * 1e3 / len(SMILES)
    check(all(g.node_pos_features.shape == (g.num_nodes, 3) for g in X),
          'every molecule embeds in 3D for MXMNet')
    order = np.random.RandomState(0).permutation(
        np.resize(np.arange(len(SMILES)), MXMNET_MOLECULES))
    out['mxmnet'] = X[order]
    out['mxmnet_y'] = np.random.RandomState(1).randn(
        len(SMILES), 1).astype(np.float32)[order]
    rng = np.random.RandomState(0)
    pairs = [(complex_pdb(rng, rng.randint(*LIGAND_ATOMS), 6.0, 'HETATM'),
              complex_pdb(rng, rng.randint(*POCKET_ATOMS), 14.0, 'ATOM'))
             for _ in range(ATOMIC_COMPLEXES)]
    feat = AtomicConvFeaturizer()
    t0 = time.perf_counter()
    C = feat.featurize(pairs)
    ms['atomic_conv'] = (time.perf_counter() - t0) * 1e3 / len(pairs)
    check(len(C) == ATOMIC_COMPLEXES and max(len(c[6]) for c in C) <= 701,
          'every complex featurizes, none above the model\'s 701 atoms')
    out['complexes'] = C
    out['complex_atoms'] = [(len(c[0]), len(c[3])) for c in C]
    out['complexes_y'] = np.random.RandomState(1).randn(
        len(C), 1).astype(np.float32)
    G = MolGraphConvFeaturizer().featurize(SMILES)
    order = np.random.RandomState(2).permutation(
        np.resize(np.arange(len(SMILES)), FEWSHOT_MOLECULES))
    out['fewshot'] = G[order]
    out['fewshot_y'] = (np.random.RandomState(3).rand(
        FEWSHOT_MOLECULES, FEWSHOT_TASKS) < 0.35).astype(np.float32)
    t0 = time.perf_counter()
    out['egnn'] = EquivariantGraphFeaturizer().featurize(
        SMILES[:EGNN_GRAPHS])
    ms['egnn'] = (time.perf_counter() - t0) * 1e3 / EGNN_GRAPHS
    out['featurize_ms'] = ms
    return out


def grover_data():
    """Phase 22's molecules: the 48 SMILES with both GROVER vocabularies
    built over them, featurized by GroverFeaturizer and repeated and
    shuffled from a seed to GROVER_MOLECULES with seeded 0/1 labels for
    GROVER_TASKS tasks, and by MATFeaturizer shuffled to MAT_MOLECULES
    with their own labels; each set's rows of each SMILES's first copy
    (the scored rows) and featurize ms a molecule."""
    import numpy as np
    from deepchem_tpu_torch.chem import mol_from_smiles
    from deepchem_tpu_torch.models import (GroverAtomVocabularyBuilder,
                                           GroverBondVocabularyBuilder,
                                           GroverFeaturizer, MATFeaturizer)
    mols = [mol_from_smiles(s) for s in SMILES]
    av, bv = GroverAtomVocabularyBuilder(), GroverBondVocabularyBuilder()
    av.build(mols)
    bv.build(mols)
    out = {'av': av, 'bv': bv, 'featurize_ms': {}}
    for key, feat, n, seed in (
            ('grover', GroverFeaturizer(atom_vocab=av, bond_vocab=bv),
             GROVER_MOLECULES, 0),
            ('mat', MATFeaturizer(), MAT_MOLECULES, 1)):
        t0 = time.perf_counter()
        X48 = feat.featurize(SMILES)
        out['featurize_ms'][key] = (time.perf_counter() - t0) * 1e3 / 48
        order = np.random.RandomState(seed).permutation(
            np.resize(np.arange(len(SMILES)), n))
        out[key] = X48[order]
        out[f'{key}_y'] = np.random.RandomState(seed + 5).randint(
            0, 2, (n, GROVER_TASKS)).astype(np.float32)
        out[f'{key}_first'] = np.array([list(order).index(i)
                                        for i in range(len(SMILES))])
    return out


_WEIGHTS = {}


def seeded_model(cls, cfg, key, device, seed, **kw):
    """``cls(**cfg, **kw)`` on ``device`` with the weights seed ``seed``
    draws.  The draws of a wide model's weights (GROVER's 186M, MAT's
    67M) take seconds on the host, and neither the layout, the batch nor
    the device moves them: they are drawn once a ``key`` and seed, and
    each later model is built on the meta device, drawing nothing, and
    loads a copy."""
    import torch
    kw = {**cfg, **kw}
    if (key, seed) not in _WEIGHTS:
        model = cls(**kw, device=device, seed=seed)
        _WEIGHTS[key, seed] = {k: v.detach().cpu().clone() for k, v in
                               model.module.state_dict().items()}
        return model
    with torch.device('meta'):
        model = cls(**kw, device=device, seed=seed)
    model.module.load_state_dict(_WEIGHTS[key, seed])
    return model


def grover_launches(X, pretrain, packed):
    """The launches a forward batch and a training step of GROVER at
    phase 22's width over ``X``'s training batches.  Flat: K1 in the
    custom-VJP sums, each MT block's first aggregation (nei_sum_sym,
    nei_sum_bonds) and its grouped later ones (their ``_g`` twins), the
    to-atom sums, and pretraining's two to-bond slot sums; in a step the
    symmetric sums' backward (K1) and again the MPN's forward for each
    level ``remat`` recomputes (at this size 'both': 2), each gather's
    backward P2, the mean readouts P3 (means, and the atom or bond
    counts once).  Packed: incidence matmuls, none of the port's
    kernels."""
    from deepchem_tpu_torch.models import GroverModel
    from deepchem_tpu_torch.models.grover import remat_mode
    if packed:
        return {}, {}, remat_mode('auto', True, 1, GROVER['hidden_size'])
    probe = GroverModel(hidden_size=8, num_heads=1, depth=2,
                        batch_size=GROVER['batch_size'], packed=False,
                        device='cpu')
    from deepchem_tpu_torch import NumpyDataset
    caps = probe._collect_uniform_batches(NumpyDataset(X))[0][0][0].shape
    mode = remat_mode('auto', False, caps[0], GROVER['hidden_size'])
    r = {'none': 0, 'qkv': 1, 'block': 1, 'both': 2}[mode]
    blocks, later = GROVER['num_mt_block'], GROVER['depth'] - 2
    per_batch = {'grover_nei_sum_sym': 1 + blocks,
                 'grover_nei_sum_sym_g': blocks * later,
                 'grover_nei_sum_bonds': 1 + blocks,
                 'grover_nei_sum_bonds_g': blocks * later,
                 'csr_segment_sum': 6 if pretrain else 3}
    if pretrain:
        per_batch['grover_slot_sum'] = 2
    per_step = dict(
        per_batch,
        grover_nei_sum_sym=1 + blocks + blocks * r,
        grover_nei_sum_sym_g=blocks * later * (1 + r),
        grover_nei_sum_bonds=1 + blocks + blocks * r,
        grover_nei_sum_bonds_g=blocks * later * (1 + r),
        grover_nei_sum_sym_bwd=1 + blocks,
        grover_nei_sum_sym_g_bwd=blocks * later,
        fused_gather_segment_sum_bwd=blocks * 2 * (1 + later)
        + (6 if pretrain else 0))
    return per_batch, per_step, mode


def grover_kernel_cases(X, dev):
    """The port's kernels at the shapes GROVER's flat layout hands them in
    phase 22's first batch of 256 (G = 3 * 8 heads, H 1024), random rows
    through the batch's own tables and CSRs, each against its plain
    version: K1 over every slot (the grouped atom sum ``[G N, H]``
    through the offset table ``a2a + g N``, the grouped incoming-bond
    sum from ``[G E, H]``, the K = 9 to-bond sum from ``[N, H]``); P2 in
    the gathers' backward (the grouped ``b2a`` gather's ``[G E, H]`` into
    ``[G N, H]``, the grouped ``b2revb`` gather's, where row 0 collects
    the ghost's and every pad slot's cotangent, the bonds' destinations',
    and the two to-bond slot sums' ``[E, H]`` into atoms and bonds); P3
    in the mean readouts over each molecule's real atoms and bonds (and
    the atom count, F 1).  Returns the K1, P2 and P3 cases."""
    import torch
    from deepchem_tpu_torch.models import GroverModel
    from deepchem_tpu_torch.models.grover import FlatGraph, _full_deg
    probe = GroverModel(hidden_size=8, num_heads=1, depth=2,
                        batch_size=GROVER['batch_size'], packed=False,
                        device=dev)
    arrs = [torch.from_numpy(a).to(dev) for a in probe._graph_inputs(
        X[:GROVER['batch_size']])]
    G, H = 3 * GROVER['num_heads'], GROVER['hidden_size']
    graph = FlatGraph(arrs[2], arrs[3], arrs[4], arrs[5], arrs[10:], G)
    nmask = arrs[7]
    N, E = arrs[0].shape[0], arrs[1].shape[0]
    gen = torch.Generator(dev).manual_seed(22)

    def rows(n, f=H):
        return torch.randn(n, f, generator=gen, device=dev)
    k1, p2, p3 = [], [], []
    for name, n, table in (('grover_sym_g', G * N, graph.a2a_g),
                           ('grover_bonds_g', G * E, graph.a2b_g),
                           ('grover_to_bond_k9', N, graph.alfb)):
        k1.append(nei_sum_case(name, rows(n), table.contiguous(),
                               _full_deg(table)))
    for name, n, csr in (
            ('grover_b2a_g_backward', G * E, graph.b2a_csr_g),
            ('grover_b2revb_g_backward', G * E, graph.revb_csr_g),
            ('grover_rev_dst_backward', E, graph.dst_csr),
            ('grover_to_bond_atoms_backward', E, graph.alfb_csr),
            ('grover_to_bond_bonds_backward', E, graph.blfb_csr)):
        p2.append(gather_case(name, rows(n), *csr))
    for name, msgs, ptr in (
            ('grover_atom_readout', rows(N - 1), graph.node_ptr),
            ('grover_bond_readout', rows(E - 1), graph.edge_ptr),
            ('grover_atom_count', nmask[1:, None].contiguous(),
             graph.node_ptr)):
        p3.append(sum_case(name, msgs, ptr))
    torch.cuda.empty_cache()
    return k1, p2, p3


def remat_grads(tag, make, X, y, dev, smi):
    """GROVER's step-1 gradients at batch 256 on the card, from one seed:
    remat 'both' (the level 'auto' picks at this size) against 'qkv' (the
    level of the card-against-CPU checks at their small batches).
    Checked within GRAD_ATOL of max(1, |g|); the bits are reported."""
    import torch
    from deepchem_tpu_torch import NumpyDataset
    grads, modes, peaks = [], ('both', 'qkv'), []
    for remat in modes:
        torch.cuda.reset_peak_memory_stats()
        m = make(dev, 0, log_frequency=1, remat=remat)
        B = m.batch_size
        grads.append({})
        m.fit(NumpyDataset(X[:B], y[:B]), nb_epoch=1, checkpoint_interval=0,
              deterministic=True, callbacks=step1_grads(grads[-1]))
        peaks.append(torch.cuda.max_memory_allocated())
        del m
    a, b = grads
    check(set(a) == set(b), f'{tag}: the same parameters get a gradient '
          'at both remat levels')
    err = max(scaled_err(a[n], g) for n, g in b.items())
    same = all(torch.equal(a[n], g) for n, g in b.items())
    print(f'phase 22 {tag} train ({smi}): step-1 gradients at batch '
          f'{GROVER["batch_size"]}, remat {modes[0]} against {modes[1]}: '
          f'max abs diff over max(1, |g|) {err:.3g} over {len(b)} '
          f'parameters, the same bits: {same}; peak memory bytes {peaks}',
          flush=True)
    check(err <= GRAD_ATOL, f'{tag}: remat both against qkv {err} > '
          f'{GRAD_ATOL}')
    return {'remat': modes, 'max_grad_err': err, 'same_bits': same,
            'peak_memory_bytes': peaks}


def grover_mat_phase(dev, smi):
    """Phase 22: the kernels at the shapes of GROVER's flat batch of 256;
    GROVER at GROVER's width in both layouts, pretraining and finetuning
    (and flat pretraining's remat levels), and MAT at its published
    width, each through ``model_phase``.  Returns the runs, the K1, P2
    and P3 cases and the remat comparison."""
    import numpy as np
    from deepchem_tpu_torch import (GroverModel, MATModel, Metric,
                                    roc_auc_score)
    gd = grover_data()
    print(f'phase 22 data ({smi}): the 48 SMILES with GROVER vocabularies '
          f'of {gd["av"].size} atom and {gd["bv"].size} bond contexts, '
          f'shuffled to {GROVER_MOLECULES}; for MAT to {MAT_MOLECULES}; '
          f'{GROVER_TASKS} seeded 0/1 tasks; featurize ms a molecule '
          f'{json.dumps(gd["featurize_ms"])}', flush=True)
    g_runs = {}

    def timed22(tag, *args, **kwargs):
        t0 = time.perf_counter()
        g_runs[tag] = model_phase(22, tag, *args, **kwargs)
        print(f'phase 22 {tag}: {time.perf_counter() - t0:.1f} s',
              flush=True)
    t0 = time.perf_counter()
    cases = grover_kernel_cases(gd['grover'], dev)
    print(f'phase 22 kernels at GROVER\'s shapes: '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    auc = [Metric(roc_auc_score, np.mean)]
    for packed in (False, True):
        for pretrain in (True, False):
            tag = (f'grover_{"packed" if packed else "flat"}_'
                   f'{"pretrain" if pretrain else "finetune"}')
            task = dict(task='pretraining', atom_vocab=gd['av'],
                        bond_vocab=gd['bv']) if pretrain else dict(
                task='finetuning', mode='classification',
                n_tasks=GROVER_TASKS)

            def make(d, seed, task=task, packed=packed, **kw):
                m = seeded_model(GroverModel, GROVER, task['task'], d, seed,
                                 packed=packed, **task, **kw)
                if m.batch_size < GROVER['batch_size']:
                    # the card-against-CPU checks' small batches: the
                    # flat layout pads to finer quanta (padding changes
                    # no answer, only the host's work)
                    m.node_quantum = m.edge_quantum = GROVER_CUT_QUANTUM
                return m
            per_batch, per_step, remat = grover_launches(gd['grover'],
                                                         pretrain, packed)
            print(f'phase 22 {tag}: remat at batch '
                  f'{GROVER["batch_size"]} {remat}; launches a batch '
                  f'{per_batch}, a step {per_step}', flush=True)
            timed22(tag, make, gd['grover'], gd['grover_y'], per_batch,
                    per_step, smi, scored=not pretrain,
                    out_tail=(GROVER_TASKS, 2), metrics=auc,
                    score_rows=gd['grover_first'], same_bits=True,
                    cpu_cut=GROVER_CPU_CUT,
                    profile_calls=GROVER_PROFILE_CALLS,
                    idle=() if pretrain else ('encoder.ffn_bond_from',
                                              'encoder.bond_from'),
                    grad_atol=GROVER_GRAD_ATOL, timed_epochs=1,
                    overfit_steps=0, tie_slack=not pretrain)
            if not packed and pretrain:
                t0 = time.perf_counter()
                remat = remat_grads(tag, make, gd['grover'], gd['grover_y'],
                                    dev, smi)
                print(f'phase 22 {tag} remat: '
                      f'{time.perf_counter() - t0:.1f} s', flush=True)
    timed22('mat', lambda d, seed, **kw: seeded_model(MATModel, MAT, 'mat',
                                                      d, seed, **kw),
            gd['mat'], gd['mat_y'], {}, {}, smi,
            out_tail=(GROVER_TASKS, 2), metrics=auc,
            score_rows=gd['mat_first'], same_bits=True,
            cpu_cut=MAT_CPU_CUT, tie_slack=True,
            profile_calls=MAT_PROFILE_CALLS)
    _WEIGHTS.clear()
    return g_runs, cases, remat


def circle_images(n, size, seed):
    """``n`` images ``[size, size, 3]`` of 1-4 discs on a noisy
    background and their masks ``[size, size]`` (1 inside a disc), from
    ``RandomState(seed)``: a mask a network can learn from its image."""
    import numpy as np
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    masks = np.zeros((n, size, size), np.float32)
    for i in range(n):
        for _ in range(rng.randint(1, 5)):
            cy, cx = rng.rand(2) * size
            r = (0.05 + 0.15 * rng.rand()) * size
            masks[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1.0
    colour = rng.rand(n, 1, 1, 3).astype(np.float32)
    images = 0.3 + 0.4 * masks[..., None] * colour \
        + 0.1 * rng.rand(n, size, size, 3).astype(np.float32)
    return images.astype(np.float32), masks


def seq_image_data():
    """Phase 23's inputs: the 48 SMILES shuffled from a seed to
    SEQ_MOLECULES as SMILES (TextCNN), SmilesToSeq's 270 tokens, 80 x 80
    SmilesToImage images, OneHotFeaturizer's ``[100, 35]`` and the
    autoencoder's token ids, with seeded 0/1 and normal labels for
    SEQ_TASKS tasks, one a SMILES (its copies agree), and the rows of each
    SMILES's first copy (the scored set); IMAGES disc images and masks at
    256 (UNet), 299 (InceptionV3, labelled by whether the discs cover
    more than the median image) and 512 pixels (OneFormer, its images in
    0-255).  Featurize ms a molecule."""
    import numpy as np
    from deepchem_tpu_torch.feat import (OneHotFeaturizer, SmilesToImage,
                                         SmilesToSeq, create_char_to_idx)
    order = np.random.RandomState(23).permutation(
        np.resize(np.arange(len(SMILES)), SEQ_MOLECULES))
    smiles = [SMILES[i] for i in order]
    out = {'smiles': np.array(smiles, dtype=object),
           'first': np.unique(order, return_index=True)[1],
           'cls': np.random.RandomState(1).randint(
               0, 2, (len(SMILES), SEQ_TASKS)).astype(np.float32)[order],
           'reg': np.random.RandomState(2).randn(
               len(SMILES), SEQ_TASKS).astype(np.float32)[order],
           'featurize_ms': {}}
    out['vocab'] = create_char_to_idx(SMILES, SMILES2VEC_SEQ['max_len'])
    for key, feat in (('tokens', SmilesToSeq(out['vocab'],
                                             **SMILES2VEC_SEQ)),
                      ('images', SmilesToImage(CHEMCEPTION['img_size'])),
                      ('onehot', OneHotFeaturizer(max_length=ONEHOT_LENGTH))):
        t0 = time.perf_counter()
        out[key] = feat.featurize(smiles)
        out['featurize_ms'][key] = (time.perf_counter() - t0) * 1e3 / len(
            smiles)
    out['chars'] = sorted(set(''.join(SMILES)))
    for size, key, seed in ((UNET_SIZE, 'unet', 3),
                            (INCEPTION_SIZE, 'inception', 4),
                            (ONEFORMER_SIZE, 'oneformer', 5)):
        out[key] = circle_images(IMAGES, size, seed)
    return out


def seq_kernel_cases(d, dev, char_dict, seq_length):
    """P2 at the shapes TextCNN's and Smiles2Vec's embedding backward
    (``gather_table_rows``) hands it in phase 23's first batch of 100:
    a random cotangent a lookup, summed into its token's row through the
    CSR of the batch's token ids that the backward builds (a stable sort
    and a count; the padding token's segment the longest), against the
    plain version (:func:`gather_case`); and the wrapper's own backward
    on the card, from the same cotangent, against ``index_select``'s in
    float64, within SUM_RTOL of max(1, |ref|).  Returns the P2 cases."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from deepchem_tpu_torch import Smiles2Vec, TextCNNModel
    from deepchem_tpu_torch.ops.segment import gather_table_rows
    gen = torch.Generator(dev).manual_seed(23)
    text = TextCNNModel(char_dict=char_dict, seq_length=seq_length,
                        **TEXTCNN, device='cpu')
    s2v = Smiles2Vec(d['vocab'], **SMILES2VEC, device='cpu')
    cases = []
    for name, model, ids in (
            ('textcnn_embedding_backward', text,
             text.smiles_to_seq_batch(d['smiles'][:text.batch_size])),
            ('smiles2vec_embedding_backward', s2v,
             d['tokens'][:s2v.batch_size])):
        table = model.module.embedding.weight.detach().to(dev)
        flat = torch.from_numpy(np.asarray(ids)).to(dev).reshape(-1).long()
        g = torch.randn(flat.shape[0], table.shape[1], generator=gen,
                        device=dev)
        order = torch.argsort(flat, stable=True).to(torch.int32)
        row_ptr = F.pad(torch.cumsum(torch.bincount(
            flat, minlength=table.shape[0]), 0), (1, 0)).to(torch.int32)
        res = gather_case(name, g, order, row_ptr)
        leaf = table.clone().requires_grad_()
        gather_table_rows(leaf, flat).backward(g)
        ref = torch.zeros(table.shape, dtype=torch.float64, device=dev)
        ref.index_add_(0, flat, g.double())
        res['wrapper_backward_err'] = max_err(leaf.grad.double(), ref)
        print(f'phase 23 {name}: {flat.shape[0]} lookups of a table '
              f'{list(table.shape)}, longest segment '
              f'{res["longest_segment"]}; gather_table_rows\' backward '
              f'{res["wrapper_backward_err"]:.3g} from float64 '
              f'index_add_', flush=True)
        check(res['wrapper_backward_err'] <= sum_tol(ref),
              f'{name}: gather_table_rows\' backward '
              f'{res["wrapper_backward_err"]} > {sum_tol(ref)}')
        cases.append(res)
    torch.cuda.empty_cache()
    return cases


def seq_image_phase(dev, smi):
    """Phase 23: P2 at the embeddings' backward shapes
    (:func:`seq_kernel_cases`); then TextCNN, Smiles2Vec, ChemCeption,
    the Aspuru-Guzik autoencoder, CNN, UNet, InceptionV3 and OneFormer at
    the JAX package's default widths, each through ``model_phase`` (cuDNN
    convolutions and GRUs, cuBLAS GEMMs; of the port's kernels only P2,
    once a step in TextCNN's and Smiles2Vec's backward, the embeddings'
    gradient), each with the same-bits check; then OneFormer's
    full-resolution label maps against the CPU's.  Returns the runs and
    the P2 cases."""
    import numpy as np
    import torch
    from deepchem_tpu_torch import (CNN, AspuruGuzikAutoEncoder, ChemCeption,
                                    InceptionV3Model, Metric, NumpyDataset,
                                    OneFormer, Smiles2Vec, TextCNNModel,
                                    UNetModel, mae_score, rms_score,
                                    roc_auc_score)
    d = seq_image_data()
    print(f'phase 23 data ({smi}): the 48 SMILES shuffled to '
          f'{SEQ_MOLECULES}, {d["tokens"].shape[1]} tokens, '
          f'{CHEMCEPTION["img_size"]}-pixel images, one-hot '
          f'{d["onehot"].shape[1:]}; {IMAGES} disc images at {UNET_SIZE}, '
          f'{INCEPTION_SIZE} and {ONEFORMER_SIZE} pixels; featurize ms a '
          f'molecule {json.dumps(d["featurize_ms"])}', flush=True)
    runs = {}
    char_dict, seq_length = TextCNNModel.build_char_dict(
        NumpyDataset(np.zeros(len(SMILES)), ids=np.array(SMILES)))
    t0 = time.perf_counter()
    cases = seq_kernel_cases(d, dev, char_dict, seq_length)
    print(f'phase 23 kernels at the embeddings\' shapes: '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    def timed23(tag, *args, **kwargs):
        t0 = time.perf_counter()
        runs[tag] = model_phase(23, tag, *args, same_bits=True, **kwargs)
        print(f'phase 23 {tag}: {time.perf_counter() - t0:.1f} s',
              flush=True)
    auc = [Metric(roc_auc_score, np.mean)]
    rms_mae = [Metric(rms_score), Metric(mae_score)]
    first = d['first']
    # TextCNN's and Smiles2Vec's embeddings: P2 once a step, their
    # gradient (gather_table_rows)
    embed_step = {'fused_gather_segment_sum_bwd': 1}
    timed23('textcnn', lambda dv, seed, **kw: TextCNNModel(
        char_dict=char_dict, seq_length=seq_length, **TEXTCNN, device=dv,
        seed=seed, **kw), d['smiles'], d['cls'], {}, embed_step, smi,
        out_tail=(SEQ_TASKS, 2), metrics=auc, score_rows=first,
        tie_slack=True, cpu_cut=SEQ_CPU_CUT, ids=d['smiles'])
    timed23('smiles2vec', lambda dv, seed, **kw: Smiles2Vec(
        d['vocab'], **SMILES2VEC, device=dv, seed=seed, **kw), d['tokens'],
        d['reg'], {}, embed_step, smi, out_tail=(SEQ_TASKS,), metrics=rms_mae,
        score_rows=first, cpu_cut=SEQ_CPU_CUT)
    timed23('chemception', lambda dv, seed, **kw: ChemCeption(
        **CHEMCEPTION, device=dv, seed=seed, **kw), d['images'], d['reg'],
        {}, {}, smi, out_tail=(SEQ_TASKS,), metrics=rms_mae,
        score_rows=first, cpu_cut=SEQ_CPU_CUT)
    ae = AspuruGuzikAutoEncoder(tokens=d['chars'], **AUTOENCODER,
                                device='cpu')
    length = max(len(s) for s in SMILES)
    ae_X = np.stack([ae._encode_input(s, length) for s in d['smiles']])
    ae_y = np.stack([ae._encode_output(s) for s in d['smiles']])
    del ae
    timed23('autoencoder', lambda dv, seed, **kw: AspuruGuzikAutoEncoder(
        tokens=d['chars'], **AUTOENCODER, device=dv, seed=seed, **kw), ae_X,
        ae_y, {}, {}, smi, scored=False, sample_outputs=True,
        cpu_cut=SEQ_CPU_CUT)
    timed23('cnn', lambda dv, seed, **kw: CNN(
        **CNN_1D, device=dv, seed=seed, **kw), d['onehot'], d['cls'], {},
        {}, smi, out_tail=(SEQ_TASKS, 2), metrics=auc, score_rows=first,
        tie_slack=True)
    images, masks = d['unet']

    def pixel_scores(model, ds):
        """Mean binary cross entropy (clipped at 1e-7, as the loss) and
        soft dice of the probabilities against the masks."""
        p = np.clip(model.predict(ds).astype(np.float64), 1e-7, 1 - 1e-7)
        t = ds.y.astype(np.float64)
        bce = -(t * np.log(p) + (1 - t) * np.log(1 - p)).mean()
        dice = 2 * (p * t).sum() / (p.sum() + t.sum())
        return {'bce': float(bce), 'soft_dice': float(dice)}
    # UNet's 31M weights are drawn once a seed (seeded_model)
    timed23('unet', lambda dv, seed, **kw: seeded_model(
        UNetModel, {}, 'unet', dv, seed, **kw), images, masks[..., None],
        {}, {}, smi,
        out_tail=(UNET_SIZE, UNET_SIZE, 1), scorer=pixel_scores,
        score_rows=np.arange(8), cpu_cut=UNET_CPU_CUT,
        overfit_steps=UNET_OVERFIT_STEPS)
    images, masks = d['inception']
    cover = masks.mean(axis=(1, 2))
    labels = (cover > np.median(cover)).astype(np.float32)[:, None]
    timed23('inception', lambda dv, seed, **kw: InceptionV3Model(
        device=dv, seed=seed, **kw), images, labels, {}, {}, smi,
        out_tail=(1, 2), metrics=auc, tie_slack=True,
        cpu_cut=INCEPTION_CPU_CUT, grad_atol_of=INCEPTION_GRAD_ATOL_OF)
    images, masks = d['oneformer']
    images = np.round(images * 255).astype(np.float32)

    def make(dv, seed, **kw):
        return OneFormer(**ONEFORMER, device=dv, seed=seed, **kw)
    timed23('oneformer', make, images, masks.astype(np.int64), {}, {}, smi,
            scored=False, sample_outputs=True, cpu_cut=ONEFORMER_CPU_CUT)
    # the label maps: the composed map brought to 512 by nearest
    # neighbour, argmax over the labels; card and CPU from one model's
    # weights agree wherever the CPU's two largest labels differ by more
    # than CPU_ATOL
    card, cpu = make(dev, 0), make('cpu', 0)
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                card.module.state_dict().items()})
    ds = NumpyDataset(images[:2])
    maps = [m.predict(ds) for m in (card, cpu)]
    sem = cpu.predict_on_generator(cpu.default_generator(ds, mode='predict'),
                                   output_types=['prediction'])[:2]
    full = torch.nn.functional.interpolate(
        torch.from_numpy(sem).permute(0, 3, 1, 2), size=images.shape[1:3],
        mode='nearest-exact').permute(0, 2, 3, 1).numpy()
    top2 = np.sort(full, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > CPU_ATOL
    agree = float((maps[0] == maps[1]).mean())
    print(f'phase 23 oneformer predict ({smi}): label maps '
          f'{maps[0].shape}, card and CPU agree on {agree:.6f} of the '
          f'pixels and on all {int(clear.sum())} whose labels lie more '
          f'than {CPU_ATOL} apart: '
          f'{bool((maps[0] == maps[1])[clear].all())}', flush=True)
    check(maps[0].shape == (2, ONEFORMER_SIZE, ONEFORMER_SIZE)
          and bool((maps[0] == maps[1])[clear].all()),
          'OneFormer: label maps of 512 pixels, the card\'s the CPU\'s '
          'where the labels are apart')
    _WEIGHTS.clear()
    return runs, cases


def write_tox21(path, rows, seed=24):
    """A Tox21-shaped ``tox21.csv.gz``: the 12 task columns, ``mol_id``
    and ``smiles``; the 48 SMILES cycled to ``rows`` rows with TOX21_BAD's
    rows, which do not parse, put in before the rows they name; seeded 0/1
    labels with TOX21_EMPTY of the cells empty and TOX21_NA written 'NA'.
    Returns the weights the loader must give the rows that parse, in file
    order (0 at an empty or NA cell)."""
    import gzip
    import numpy as np
    from deepchem_tpu_torch.molnet.load_function import TOX21_TASKS
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, (rows, len(TOX21_TASKS))).astype(str)
    r = rng.uniform(size=labels.shape)
    labels[r < TOX21_EMPTY + TOX21_NA] = 'NA'
    labels[r < TOX21_EMPTY] = ''
    lines = [','.join(TOX21_TASKS + ['mol_id', 'smiles'])]
    for i in range(rows):
        if i in TOX21_BAD:
            lines.append(','.join(['1'] * len(TOX21_TASKS)
                                  + [f'TOX-BAD{i}', TOX21_BAD[i]]))
        lines.append(','.join(list(labels[i]) + [f'TOX{20000 + i}',
                                                 SMILES[i % len(SMILES)]]))
    with gzip.open(path, 'wt') as f:
        f.write('\n'.join(lines) + '\n')
    return (labels != '') & (labels != 'NA')


def same_graphs(a, b) -> bool:
    """Two object arrays of GraphData with equal arrays, bit for bit."""
    return len(a) == len(b) and all(
        g.node_features.tobytes() == h.node_features.tobytes()
        and g.edge_index.tobytes() == h.edge_index.tobytes()
        for g, h in zip(a, b))


def same_split(a, b) -> bool:
    """Two datasets with the same X, y, w and ids, bit for bit."""
    return same_graphs(a.X, b.X) and all(
        getattr(a, k).dtype == getattr(b, k).dtype
        and getattr(a, k).tobytes() == getattr(b, k).tobytes()
        for k in ('y', 'w')) and list(a.ids) == list(b.ids)


def stop_after(n):
    """A fit callback that ends the run after step ``n``."""
    def stop(model, step):
        if step >= n:
            raise StopIteration
    return stop


def molnet_phase(dev, smi):
    """Phase 24: the data layer and the MoleculeNet harness on bench.py's
    main path.  Writes a Tox21-shaped file of TOX21_ROWS molecules, loads
    it with ``load_tox21`` (checks the tasks, the split sizes, w at every
    empty cell and the balancing weights), reloads it from the cache (bit
    for bit), runs the pipeline again step by step for its seconds, trains
    GraphConvModel at bench.py's width with ``fit_on_device`` from the
    train DiskDataset (launches a step as phase 11, epoch losses bit for
    bit a NumpyDataset's run, and beside the CPU's; ``fit``'s step-1
    gradients within GRAD_ATOL of the CPU's), scores it
    through the loader's transformers (ROC-AUC within ROC_ATOL of the
    CPU's), then a scaffold split of the whole set, one ``run_benchmark``
    row and a grid search over two learning rates.  Returns the kernels'
    launches over the fit_on_device run."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from deepchem_tpu_torch import GraphConvModel, Metric, roc_auc_score
    from deepchem_tpu_torch.data import CSVLoader, DiskDataset, NumpyDataset
    from deepchem_tpu_torch.feat import ConvMolFeaturizer
    from deepchem_tpu_torch.feat.base import Featurizer
    from deepchem_tpu_torch.hyper import GridHyperparamOpt
    from deepchem_tpu_torch.molnet import load_tox21
    from deepchem_tpu_torch.molnet.load_function import TOX21_TASKS
    from deepchem_tpu_torch.molnet.run_benchmark import run_benchmark
    from deepchem_tpu_torch.splits import RandomSplitter, ScaffoldSplitter
    from deepchem_tpu_torch.trans import BalancingTransformer
    head = 'phase 24 molnet'
    work = tempfile.mkdtemp(prefix='chip-smoke-molnet-')
    try:
        data_dir, save_dir = (os.path.join(work, d) for d in ('data',
                                                             'save'))
        os.makedirs(data_dir)
        n = TOX21_ROWS
        want_w = write_tox21(os.path.join(data_dir, 'tox21.csv.gz'), n)
        print(f'{head} data: tox21.csv.gz of {n + len(TOX21_BAD)} rows '
              f'({len(TOX21_BAD)} that do not parse), '
              f'{int((~want_w).sum())} of {want_w.size} label cells empty '
              f'or NA', flush=True)

        # load, as bench.py:52-53 does
        pools = Featurizer.pool_runs
        t0 = time.perf_counter()
        tasks, (train, valid, test), transformers = load_tox21(
            featurizer='graphconv', splitter='random', splitter_seed=123,
            reload=False, data_dir=data_dir, save_dir=save_dir)
        load_s = time.perf_counter() - t0
        pool_ran = Featurizer.pool_runs > pools
        sizes = (len(train), len(valid), len(test))
        want_sizes = (int(0.8 * n), int(0.9 * n) - int(0.8 * n),
                      n - int(0.9 * n))
        print(f'{head} load ({smi}): load_tox21 in {load_s:.3f} s, '
              f'{len(tasks)} tasks, splits {sizes}, the featurizer pool '
              f'{"ran" if pool_ran else "did not run"} (n_jobs '
              f'{os.cpu_count()})', flush=True)
        check(list(tasks) == TOX21_TASKS, 'the 12 Tox21 tasks')
        check(sizes == want_sizes and (n != 8014 or sizes == TOX21_SPLIT),
              f'splits {sizes}, not {want_sizes} of {n} molecules')
        check(all(isinstance(d, DiskDataset) for d in (train, valid, test)),
              'the splits are DiskDatasets')
        perm = np.random.RandomState(123).permutation(n)
        got_w = np.concatenate([d.w for d in (train, valid, test)])
        check(np.array_equal(got_w != 0, want_w[perm]),
              'w is 0 exactly at the empty and NA cells')
        # the balancing transformer recomputed on train's own arrays
        raw_w = want_w[perm][:sizes[0]].astype(np.float64)
        again = BalancingTransformer(dataset=NumpyDataset(
            np.zeros(sizes[0]), train.y, raw_w))
        bal_err = max(abs(again.weights[t][c] - transformers[0].weights[t][c])
                      for t in range(len(tasks)) for c in again.weights[t])
        bal_err = max(bal_err, float(np.abs(again.transform_array(
            None, train.y, raw_w, None)[2] - train.w).max()))
        print(f'{head} load: balancing weights and w against the '
              f'transformer recomputed on train\'s arrays, max abs diff '
              f'{bal_err:.3g}', flush=True)
        check(bal_err <= BALANCE_ATOL, f'balancing {bal_err} > '
              f'{BALANCE_ATOL}')

        # reload from the cache: the same arrays, bit for bit
        t0 = time.perf_counter()
        _, cached, cached_t = load_tox21(
            featurizer='graphconv', splitter='random', splitter_seed=123,
            reload=True, data_dir=data_dir, save_dir=save_dir)
        reload_s = time.perf_counter() - t0
        same = all(same_split(a, b) for a, b in zip((train, valid, test),
                                                     cached))
        print(f'{head} reload: {reload_s:.3f} s, the same X, y, w and ids '
              f'bit for bit: {same}', flush=True)
        check(same and cached_t[0].weights == transformers[0].weights,
              'reload returns the same splits and transformer')

        # the same pipeline step by step, for its seconds
        loader = CSVLoader(TOX21_TASKS, ConvMolFeaturizer(),
                           feature_field='smiles')
        t0 = time.perf_counter()
        full = loader.create_dataset(os.path.join(data_dir, 'tox21.csv.gz'),
                                     data_dir=os.path.join(work, 'full'))
        t1 = time.perf_counter()
        parts = RandomSplitter().train_valid_test_split(full, seed=123)
        t2 = time.perf_counter()
        bal = BalancingTransformer(dataset=parts[0])
        parts = [bal.transform(d) for d in parts]
        t3 = time.perf_counter()
        seconds = {'read': loader.seconds['read'],
                   'featurize': loader.seconds['featurize'],
                   'write_shards': loader.seconds['write'],
                   'create_dataset': t1 - t0, 'split': t2 - t1,
                   'transform': t3 - t2}
        print(f'{head} load seconds ({smi}): '
              f'{json.dumps({k: round(v, 3) for k, v in seconds.items()})}'
              f'; {n / seconds["featurize"]:.0f} molecules a second '
              f'featurized', flush=True)
        check(all(same_split(a, b) for a, b in zip(parts, (train, valid,
                                                           test))),
              'the step-by-step pipeline gives load_tox21\'s splits')

        # training: fit_on_device from the train DiskDataset
        B = GRAPHCONV['batch_size']
        S = -(-sizes[0] // B)
        flat = NumpyDataset(train.X, train.y, train.w, train.ids)
        runs = {}
        for tag, ds, device in (('disk', train, dev), ('numpy', flat, dev),
                                ('cpu', flat, 'cpu')):
            model = GraphConvModel(**GRAPHCONV, device=device, seed=1)
            if device != 'cpu':
                torch.cuda.synchronize()
                reset_launch_counts()
            losses = []
            t0 = time.perf_counter()
            model.fit_on_device(ds, nb_epoch=MOLNET_EPOCHS, seed=0,
                                all_losses=losses)
            if device != 'cpu':
                torch.cuda.synchronize()
            runs[tag] = (model, losses, launch_counts(),
                         time.perf_counter() - t0)
        trainer, losses, counts, fit_s = runs['disk']
        steps = trainer.get_global_step()
        cpu_err = max(abs(a - b) / max(1.0, abs(b))
                      for a, b in zip(losses, runs['cpu'][1]))
        print(f'{head} train ({smi}): fit_on_device from the train '
              f'DiskDataset, {steps} steps of {B} in {fit_s:.3f} s (packing '
              f'included); loss per epoch {losses}, from a NumpyDataset '
              f'{runs["numpy"][1]}, on the CPU {runs["cpu"][1]} (max '
              f'{cpu_err:.3g} of max(1, |loss|)); launches {counts}',
              flush=True)
        check(steps == MOLNET_EPOCHS * S and len(losses) == MOLNET_EPOCHS
              and bool(np.all(np.isfinite(losses))),
              f'{MOLNET_EPOCHS * S} steps, {MOLNET_EPOCHS} finite losses')
        check(losses == runs['numpy'][1], 'the DiskDataset\'s epoch losses '
              'bit for bit the NumpyDataset\'s')
        check(all(torch.equal(a, b) for a, b in zip(
            trainer.module.state_dict().values(),
            runs['numpy'][0].module.state_dict().values())),
            'the DiskDataset\'s weights bit for bit the NumpyDataset\'s')
        # the card against the CPU from the same weights and batches:
        # fit's step-1 gradients held (as phase 11's), its first
        # MOLNET_TRAJECTORY steps' losses recorded
        steps_of, grads = {}, {}
        for device in (dev, 'cpu'):
            model = GraphConvModel(**GRAPHCONV, device=device, seed=1,
                                   log_frequency=1)
            steps_of[device], grads[device] = [], {}
            model.fit(train, nb_epoch=1, deterministic=True,
                      checkpoint_interval=0,
                      callbacks=[step1_grads(grads[device]),
                                 stop_after(MOLNET_TRAJECTORY)],
                      all_losses=steps_of[device])
        grad_err = max((grads[dev][k] - g).abs().max().item()
                       for k, g in grads['cpu'].items())
        step_err = [abs(a - b) / max(1.0, abs(b))
                    for a, b in zip(steps_of[dev], steps_of['cpu'])]
        print(f'{head} train ({smi}): fit from the train DiskDataset, '
              f'card against CPU: step-1 gradients max abs diff '
              f'{grad_err:.3g} over {len(grads["cpu"])} parameters; the '
              f'first {MOLNET_TRAJECTORY} steps\' losses, of max(1, |loss|) '
              f'a step: {[float(f"{e:.3g}") for e in step_err]}', flush=True)
        check(len(grads['cpu']) == len(grads[dev]) and grad_err <= GRAD_ATOL,
              f'step-1 gradients {grad_err} > {GRAD_ATOL}')
        per_step = {'nei_sum': 2, 'nei_max_fwd': 2, 'graph_max_pool_fwd': 1,
                    'csr_segment_sum': 1, 'nei_sum_bwd': 1, 'nei_max_bwd': 2,
                    'graph_max_pool_bwd': 1}
        for k, v in counts.items():
            check(v == per_step.get(k, 0) * steps, f'{head}: {k} launched '
                  f'{v} times, not {per_step.get(k, 0) * steps}')

        # scoring through the loader's transformers, card against CPU
        metric = Metric(roc_auc_score, np.mean)
        cpu_model = runs['cpu'][0]
        cpu_model.module.load_state_dict(
            {k: v.cpu() for k, v in trainer.module.state_dict().items()})
        auc = trainer.evaluate(valid, [metric],
                               transformers)['roc_auc_score']
        cpu_auc = cpu_model.evaluate(valid, [metric],
                                     transformers)['roc_auc_score']
        print(f'{head} evaluate ({smi}): valid ROC-AUC {auc:.6f} on the '
              f'card, {cpu_auc:.6f} on the CPU from its weights', flush=True)
        check(bool(np.isfinite(auc)) and abs(auc - cpu_auc) <= ROC_ATOL,
              f'ROC-AUC {auc} within {ROC_ATOL} of the CPU\'s {cpu_auc}')
        del runs, cpu_model, trainer

        # a scaffold split, a benchmark row, a grid search
        t0 = time.perf_counter()
        scaffold = ScaffoldSplitter().split(full)
        scaffold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = run_benchmark(
            ['tox21'], 'graphconv', device=dev, data_dir=data_dir,
            save_dir=save_dir, out_path=work,
            hyper_parameters={'batch_size': B, 'n_filters': 64,
                              'n_fully_connected_nodes': 128,
                              'learning_rate': GRAPHCONV['learning_rate'],
                              'nb_epoch': 2})
        bench_s = time.perf_counter() - t0

        def build(**params):
            return GraphConvModel(**dict(GRAPHCONV, **params), device=dev)
        t0 = time.perf_counter()
        best, best_params, scores = GridHyperparamOpt(
            build).hyperparam_search(
            {'learning_rate': MOLNET_SEARCH_RATES}, train, valid, metric,
            transformers, nb_epoch=1)
        search_s = time.perf_counter() - t0
        print(f'{head} harness ({smi}): scaffold split '
              f'{[len(x) for x in scaffold]} in {scaffold_s:.3f} s; '
              f'run_benchmark row {json.dumps(rows)} in {bench_s:.3f} s; '
              f'grid search {json.dumps(scores)}, best {best_params}, in '
              f'{search_s:.3f} s', flush=True)
        check(sum(map(len, scaffold)) == n and len(scaffold[0]) > 0,
              'the scaffold split covers the set')
        check(len(rows) == 1 and 0 <= rows[0]['valid_score'] <= 1
              and 0 <= rows[0]['train_score'] <= 1,
              'one run_benchmark row with scores in [0, 1]')
        check(len(scores) == len(MOLNET_SEARCH_RATES)
              and best_params['learning_rate'] in MOLNET_SEARCH_RATES
              and all(np.isfinite(v) for v in scores.values()),
              'the grid search scores both rates')
        return counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


def zero_counts():
    return {k: 0 for k in launch_counts()}


def fewshot_phase(kind, X, y, smi):
    """Phase 21: SupportGraphClassifier(model=kind) at FEWSHOT on the card
    against the same on the CPU: a support set of task 0 answers requests
    of REQUESTS molecules (CPU_ATOL; P2 2 and P3 2 an encoding, each chunk
    of n_test queries encoded with the support), LATENCY_REQUESTS timed
    requests of 16, 3 epochs of FEWSHOT_EPISODES episodes (the losses
    within CPU_ATOL relative of the CPU's from the same weights and seed;
    an episode encodes twice and adds P2 once an encoding in the
    backward), step-1 gradients (GRAD_ATOL of max(1, |g|)), a fixed
    episode that overfits, two runs of 2 episodes from one seed the same
    bits, and evaluate's ROC-AUC (EVAL_ATOL).  Returns the launches of the
    requests and the episodes and the numbers, as model_phase."""
    import numpy as np
    import torch
    from deepchem_tpu_torch import (NumpyDataset, SupportGraphClassifier,
                                    roc_auc_score)
    from deepchem_tpu_torch.data import EpisodeGenerator, get_task_support
    head = f'phase 21 fewshot_{kind}'
    dev = torch.device('cuda', 0)
    ds = NumpyDataset(X, y)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()

    def make(device, seed):
        return SupportGraphClassifier(model=kind, device=device, seed=seed,
                                      **FEWSHOT)
    model, cpu = make(dev, 0), make('cpu', 0)
    model.fit(ds, nb_epochs=1, n_episodes_per_epoch=FEWSHOT_TASKS)
    cpu._caps = model._caps
    cpu.fit(ds, nb_epochs=1, n_episodes_per_epoch=FEWSHOT_TASKS)
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                model.module.state_dict().items()})
    support = get_task_support(ds, 1, FEWSHOT['n_pos'], FEWSHOT['n_neg'], 0,
                               np.random.RandomState(1))[0]

    def answer(m, Xs):
        return m.predict_on_support(support, NumpyDataset(Xs))
    answer(model, X[:16])                                 # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    outs, request_ms, start = [], [], 0
    for n in REQUESTS:
        t0 = time.perf_counter()
        outs.append(answer(model, X[start:start + n]))
        request_ms.append((time.perf_counter() - t0) * 1e3)
        start += n
    serve = launch_counts()
    worst, start = 0.0, 0
    for n, out in zip(REQUESTS, outs):
        ref = answer(cpu, X[start:start + n])
        check(out.shape == ref.shape == (n,) and bool(np.isfinite(out).all())
              and bool(((out >= 0) & (out <= 1)).all()),
              f'fewshot {kind} request of {n}: [n] probabilities, finite')
        worst = max(worst, float(np.abs(out - ref).max()))
        start += n
    n_test = FEWSHOT['n_test']
    # each chunk of n_test queries is answered with the support encoded
    # beside it: two encodings a chunk
    encodings = sum(2 * -(-n // n_test) for n in REQUESTS)
    print(f'{head} serve ({smi}): requests {list(REQUESTS)} molecules on a '
          f'support of {len(support)}, ms per request '
          f'{[round(t, 3) for t in request_ms]}; max abs diff against the '
          f'CPU {worst:.3g}; launches {serve}', flush=True)
    check(worst <= CPU_ATOL, f'fewshot {kind} card vs CPU {worst}')
    for k, v in serve.items():
        want = {'fused_gather_segment_sum': 2, 'csr_segment_sum': 2}.get(
            k, 0) * encodings
        check(v == want, f'fewshot {kind} serve: {k} launched {v} times, '
              f'not {want}')
    latency = []
    for i in range(LATENCY_REQUESTS):
        lo = (16 * i) % (len(X) - 16)
        t0 = time.perf_counter()
        answer(model, X[lo:lo + 16])
        latency.append((time.perf_counter() - t0) * 1e3)
    p50, p90 = (float(v) for v in np.percentile(latency, [50, 90]))
    print(f'{head} serve: {LATENCY_REQUESTS} requests of 16 molecules: '
          f'median {p50:.3f} ms, p90 {p90:.3f} ms', flush=True)

    # episodes: 3 epochs, card and CPU from the same weights, optimizer
    # state and seed (each built, and the card warmed up, by a first fit)
    trainer, cpu_trainer = make(dev, 1), make('cpu', 1)
    for t in (trainer, cpu_trainer):
        t._caps = model._caps
        t.fit(ds, nb_epochs=1, n_episodes_per_epoch=FEWSHOT_TASKS)
        t.rng = np.random.RandomState(5)
    cpu_trainer.module.load_state_dict(
        {k: v.cpu() for k, v in trainer.module.state_dict().items()})
    cpu_trainer._opt.load_state_dict(trainer._opt.state_dict())
    losses = [[], []]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for t, out in ((trainer, losses[0]), (cpu_trainer, losses[1])):
        for _ in range(3):
            out.append(t.fit(ds, nb_epochs=1,
                             n_episodes_per_epoch=FEWSHOT_EPISODES,
                             log_every=0))
        if t is trainer:
            torch.cuda.synchronize()
            episode_ms = (time.perf_counter() - t0) * 1e3 / (
                3 * FEWSHOT_EPISODES)
            fit = launch_counts()
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(*losses))
    print(f'{head} train ({smi}): 3 epochs of {FEWSHOT_EPISODES} episodes '
          f'({FEWSHOT["n_pos"]} + {FEWSHOT["n_neg"]} support, {n_test} '
          f'queries), {episode_ms:.3f} ms an episode; last losses '
          f'{[round(v, 5) for v in losses[0]]}, on the CPU '
          f'{[round(v, 5) for v in losses[1]]}; launches {fit}', flush=True)
    check(all(np.isfinite(losses[0])) and loss_err <= CPU_ATOL,
          f'fewshot {kind}: losses {loss_err} of max(1, |loss|) from the '
          'CPU\'s')
    per_episode = {'fused_gather_segment_sum': 4,
                   'fused_gather_segment_sum_bwd': 2, 'csr_segment_sum': 4}
    for k, v in fit.items():
        want = per_episode.get(k, 0) * 3 * FEWSHOT_EPISODES
        check(v == want, f'fewshot {kind} fit: {k} launched {v} times, '
              f'not {want}')

    # step-1 gradients from the same weights; a fixed episode overfits
    episode = next(EpisodeGenerator(ds, FEWSHOT['n_pos'], FEWSHOT['n_neg'],
                                    n_test, 1, np.random.RandomState(7)))
    packed = model._pack_episode(*episode[1:])
    grads = []
    for m in (model, cpu):
        ep = m._to_device(packed)
        m.module.train()
        m.module.zero_grad()
        m.loss(m.module(*ep[:3]), *ep[3:]).backward()
        grads.append({n: p.grad.detach().cpu().clone()
                      for n, p in m.module.named_parameters()})
    grad_err = max(scaled_err(grads[0][n], g) for n, g in grads[1].items())
    zero = [n for n, g in grads[0].items() if not g.abs().max() > 0]
    print(f'{head} train: step-1 gradients, card against CPU, max abs diff '
          f'over max(1, |g|) {grad_err:.3g} over {len(grads[1])} '
          f'parameters; zero gradients: {zero}', flush=True)
    check(grad_err <= GRAD_ATOL and not zero,
          f'fewshot {kind} step-1 gradients {grad_err}, zero {zero}')
    overfit = make(dev, 2)
    overfit._caps = model._caps
    ep = overfit._to_device(packed)
    overfit._build(ep)
    fixed = [float(overfit._step(ep)) for _ in range(FEWSHOT_OVERFIT_STEPS)]
    below = next((i + 1 for i, v in enumerate(fixed) if v < 0.9 * fixed[0]),
                 None)
    print(f'{head} train: one fixed episode, lr '
          f'{overfit.optimizer.learning_rate}: loss {fixed[0]:.5f} at step '
          f'1, {min(fixed):.5f} at best, below 0.9 of the first at step '
          f'{below}', flush=True)
    check(below is not None, f'fewshot {kind}: a fixed episode overfits')
    del overfit

    # two runs of 2 episodes from one seed: the same bits
    runs = []
    for _ in range(2):
        m = make(dev, 0)
        m._caps = model._caps
        store = []
        for _, s_ds, q_ds in EpisodeGenerator(
                ds, FEWSHOT['n_pos'], FEWSHOT['n_neg'], n_test, 1,
                np.random.RandomState(8)):
            ep = m._to_device(m._pack_episode(s_ds, q_ds))
            if m.module is None:
                m._build(ep)
            m._step(ep)
            store.append({n: p.grad.detach().clone()
                          for n, p in m.module.named_parameters()})
            if len(store) == 2:
                break
        store.append({n: p.detach().clone()
                      for n, p in m.module.named_parameters()})
        runs.append(store)
    differ = sorted({n for a, b in zip(*runs) for n, t in a.items()
                     if not torch.equal(t.view(torch.int32),
                                        b[n].view(torch.int32))})
    print(f'{head} train: two runs of 2 episodes from seed 0 on the card, '
          f'every gradient and weight the same bits: {not differ}; '
          f'differing: {differ}', flush=True)
    check(not differ, f'fewshot {kind}: two runs from one seed differ in '
          f'{differ}')

    # evaluate: per-task ROC-AUC over 10 sampled supports
    cpu.module.load_state_dict({k: v.cpu() for k, v in
                                trainer.module.state_dict().items()})
    trainer.rng, cpu.rng = (np.random.RandomState(9) for _ in range(2))
    t0 = time.perf_counter()
    means, stds = trainer.evaluate(ds, roc_auc_score, n_trials=10)
    eval_ms = (time.perf_counter() - t0) * 1e3
    cpu_means, _ = cpu.evaluate(ds, roc_auc_score, n_trials=10)
    eval_err = max(abs(means[t] - cpu_means[t]) for t in cpu_means)
    print(f'{head} evaluate ({smi}): ROC-AUC by task {json.dumps(means)} '
          f'(std {json.dumps(stds)}) on the card in {eval_ms:.3f} ms, '
          f'{json.dumps(cpu_means)} on the CPU', flush=True)
    check(set(means) == set(cpu_means) and means and eval_err <= EVAL_ATOL,
          f'fewshot {kind} evaluate within {EVAL_ATOL} of the CPU '
          f'({eval_err})')
    serve_us, serve_kernels = device_us_all(lambda: answer(model, X[:16]))
    step_us, step_kernels = device_us_all(
        lambda: trainer._step(trainer._to_device(packed)))
    numbers = {'request16_median_ms': p50, 'request16_p90_ms': p90,
               'episode_ms': episode_ms, 'request16_device_us': serve_us,
               'request16_device_kernels': serve_kernels,
               'step_device_us': step_us, 'step_device_kernels': step_kernels,
               'max_request_err': worst, 'step1_grad_err': grad_err,
               'eval_err': eval_err, 'same_bits_checked': True,
               'peak_memory_bytes': torch.cuda.max_memory_allocated(),
               'peak_over_held_bytes': torch.cuda.max_memory_allocated()
               - held}
    print(f'{head} card: {json.dumps(numbers)}', flush=True)
    return serve, fit, zero_counts(), numbers


def egnn_phase(graphs, smi):
    """Phase 21: EGNNLayer(EGNN_HIDDEN, EGNN_HIDDEN, coordinates updated,
    the binned edge lengths as edge inputs) on ``graphs`` packed into one
    batch with its CSR, seeded features: the card's outputs within
    CPU_ATOL and every gradient (features, coordinates, edge inputs,
    weights) within GRAD_ATOL of max(1, |ref|) of the CPU's from the same
    weights, P2 3 a forward and 4 in its backward, the same bits on a
    repeat, host ms and device µs a forward and backward."""
    import numpy as np
    import torch
    from deepchem_tpu_torch.feat import BatchGraphData, bucket_caps
    from deepchem_tpu_torch.models import EGNNLayer
    from deepchem_tpu_torch.ops import CooCsr, coo_csr
    dev = torch.device('cuda', 0)
    batch = BatchGraphData(list(graphs))
    node_cap, edge_cap = bucket_caps(batch.num_nodes + 1, batch.num_edges)
    d = batch.pad(node_cap, edge_cap, num_graphs=len(graphs))
    ef = np.zeros((edge_cap, 5), np.float32)
    ef[:batch.num_edges] = np.concatenate([g.edge_weights for g in graphs])
    src, dst = d['edge_index']
    rng = np.random.RandomState(0)
    h = rng.randn(node_cap, EGNN_HIDDEN).astype(np.float32)
    gh = rng.randn(node_cap, EGNN_HIDDEN).astype(np.float32)
    gx = rng.randn(node_cap, 3).astype(np.float32)
    layer = EGNNLayer(EGNN_HIDDEN, EGNN_HIDDEN, edge_features=5,
                      generator=torch.Generator().manual_seed(0))
    cpu_layer = EGNNLayer(EGNN_HIDDEN, EGNN_HIDDEN, edge_features=5)
    cpu_layer.load_state_dict(layer.state_dict())
    layer = layer.to(dev)

    def run(lay, device, backward=True):
        def t(a, grad=False):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device).requires_grad_(grad)
        ins = [t(h, True), t(d['node_pos_features'], True)]
        e = t(ef, True)
        csr = CooCsr(*(t(a) for a in coo_csr(src, dst, node_cap)))
        lay.zero_grad()
        out_h, out_x = lay(*ins, t(src).long(), t(dst).long(),
                           t(d['edge_mask']), csr, ef=e)
        if not backward:
            return out_h, out_x
        ((out_h * t(gh)).sum() + (out_x * t(gx)).sum()).backward()
        grads = {'h': ins[0].grad, 'x': ins[1].grad, 'ef': e.grad,
                 **{n: p.grad for n, p in lay.named_parameters()}}
        return ({k: v.detach().cpu() for k, v in (('h', out_h),
                                                  ('x', out_x))},
                {k: v.detach().cpu() for k, v in grads.items()})
    run(layer, dev)                                       # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.no_grad():
        run(layer, dev, backward=False)
    serve = launch_counts()
    reset_launch_counts()
    outs, grads = run(layer, dev)
    step = launch_counts()
    outs2, grads2 = run(layer, dev)
    ref_outs, ref_grads = run(cpu_layer, 'cpu')
    out_err = max(scaled_err(outs[k], ref_outs[k]) for k in outs)
    grad_err = max(scaled_err(grads[k], ref_grads[k]) for k in ref_grads)
    same = all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
               for a, b in ((outs, outs2), (grads, grads2)) for k in a)
    moved = float((outs['x'] - torch.from_numpy(
        d['node_pos_features'])).abs().max())
    ms = time_ms(lambda: run(layer, dev), iters=50)
    us, kernels = device_us_all(lambda: run(layer, dev))
    print(f'phase 21 egnn ({smi}): {len(graphs)} graphs, {batch.num_nodes} '
          f'atoms, {batch.num_edges} edges padded to [{node_cap}, '
          f'{edge_cap}], hidden {EGNN_HIDDEN}: card against CPU, outputs '
          f'{out_err:.3g}, gradients of h, x, the edge inputs and '
          f'{len(grads) - 3} weights {grad_err:.3g} of max(1, |ref|); '
          f'coordinates moved up to {moved:.3g}; the same bits on a repeat: '
          f'{same}; launches forward {serve}, forward and backward {step}; '
          f'{ms:.4f} ms and {us} device µs ({kernels} kernels) a forward '
          f'and backward', flush=True)
    check(out_err <= CPU_ATOL and grad_err <= GRAD_ATOL and same,
          f'EGNN: outputs {out_err}, gradients {grad_err}, same bits {same}')
    for counts, want in ((serve, {'fused_gather_segment_sum': 3}),
                         (step, {'fused_gather_segment_sum': 3,
                                 'fused_gather_segment_sum_bwd': 4})):
        for k, v in counts.items():
            check(v == want.get(k, 0), f'EGNN: {k} launched {v} times, not '
                  f'{want.get(k, 0)}')
    numbers = {'forward_backward_ms': ms, 'forward_backward_device_us': us,
               'device_kernels': kernels, 'max_out_err': out_err,
               'max_grad_err': grad_err, 'same_bits_checked': True}
    return serve, step, zero_counts(), numbers


def fit_bits(make, X, y, dev, steps=2, ids=None):
    """Two fresh models from seed 0 ``fit`` the same first ``steps``
    batches (``deterministic=True``; ``ids`` the samples' ids where
    given) on ``dev``: the names of the
    parameters whose gradient after any step, or whose weight after the
    last, differs in any bit between the two runs (``[]``: the step is
    bit-reproducible), and the parameter count."""
    import torch
    from deepchem_tpu_torch import NumpyDataset
    runs = []
    for _ in range(2):
        model = make(dev, 0, log_frequency=1)
        grads = []

        def grab(m, step, out=grads):
            out.append({n: p.grad.detach().clone()
                        for n, p in m.module.named_parameters()
                        if p.grad is not None})
        B = model.batch_size
        model.fit(NumpyDataset(X[:steps * B], y[:steps * B],
                               ids=None if ids is None else ids[:steps * B]),
                  nb_epoch=1, checkpoint_interval=0, deterministic=True,
                  callbacks=grab)
        weights = {n: p.detach().clone()
                   for n, p in model.module.named_parameters()}
        runs.append((grads, weights))
        del model
    (ga, wa), (gb, wb) = runs
    differ = set()
    check(len(ga) == len(gb) == steps, f'{steps} steps in each fit')
    for a, b in zip(ga, gb):
        differ |= {n for n, g in a.items() if not torch.equal(
            g.view(torch.int32), b[n].view(torch.int32))}
    differ |= {n for n, w in wa.items() if not torch.equal(
        w.view(torch.int32), wb[n].view(torch.int32))}
    return sorted(differ), len(wa)


def step1_grads(store):
    """A fit callback that keeps a copy of every gradient after step 1."""
    def grab(model, step):
        if step == 1:
            store.update({n: p.grad.detach().cpu().clone()
                          for n, p in model.module.named_parameters()
                          if p.grad is not None})
    return grab


def engine_data():
    """The 48 SMILES featurized for GraphConvModel, repeated and shuffled
    from a seed to ENGINE_MOLECULES, with seeded 0/1 labels for its 12
    tasks and seeded normal ones for the uncertainty regressor."""
    import numpy as np
    from deepchem_tpu_torch import ConvMolFeaturizer
    X48 = ConvMolFeaturizer().featurize(SMILES)
    order = np.random.RandomState(0).permutation(
        np.resize(np.arange(len(SMILES)), ENGINE_MOLECULES))
    labels = np.random.RandomState(2).randint(
        0, 2, (ENGINE_MOLECULES, GRAPHCONV['n_tasks'])).astype(np.float32)
    values = np.random.RandomState(3).randn(
        ENGINE_VALID, GRAPHCONV['n_tasks']).astype(np.float32)
    return X48[order], labels, values


@contextlib.contextmanager
def plain_routed():
    """K1, K2, K3 and P3 through their plain PyTorch versions, on the card
    too, while the block runs."""
    import importlib
    nei = importlib.import_module('deepchem_tpu_torch.ops.nei_table')
    seg = importlib.import_module('deepchem_tpu_torch.ops.segment')
    csr = importlib.import_module('deepchem_tpu_torch.ops.csr_segment')
    swaps = [
        (nei, '_nei_sum_forward', lambda h, table, deg, counter,
         attr='launches': nei.nei_sum_reference(h, table, deg)),
        (nei, '_nei_max_forward', nei.nei_max_reference),
        (nei, '_nei_max_backward', nei.nei_max_backward_reference),
        (seg, '_graph_max_forward', seg.graph_max_pool_reference),
        (seg, '_graph_max_backward', seg.graph_max_pool_backward_reference),
        (csr, '_segment_sum_forward', csr.csr_segment_sum_reference)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    for mod, attr, fn in swaps:
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def engine_phase(dev, smi):
    """Phase 15: the engine's public surface on GraphConvModel at bench.py's
    width.  Returns the kernels' launches over the phase."""
    import gc
    import shutil
    import tempfile
    import numpy as np
    import torch
    from deepchem_tpu_torch import GraphConvModel, Metric, NumpyDataset
    from deepchem_tpu_torch.metrics import (accuracy_score, prc_auc_score,
                                            roc_auc_score)
    from deepchem_tpu_torch.models.callbacks import ValidationCallback
    from deepchem_tpu_torch.models.optimizers import ExponentialDecay
    t_phase = time.perf_counter()
    X, y, values = engine_data()
    ds = NumpyDataset(X, y, np.ones_like(y))
    valid = NumpyDataset(X[:ENGINE_VALID], y[:ENGINE_VALID])
    B = GRAPHCONV['batch_size']
    S = ENGINE_MOLECULES // B
    sched = ExponentialDecay(*ENGINE_SCHEDULE)
    kw = dict(GRAPHCONV, learning_rate=sched)
    reset_launch_counts()

    # schedules: step 1 on the card and the CPU from the same weights
    grads, step1 = [], []
    for device in (dev, 'cpu'):
        m = GraphConvModel(**kw, device=device, seed=1, log_frequency=1)
        grads.append({})
        out = []
        m.fit(NumpyDataset(X[:B], y[:B]), nb_epoch=1, checkpoint_interval=0,
              callbacks=step1_grads(grads[-1]), all_losses=out)
        step1.append(out[0])
    grad_err = max((grads[0][n] - g).abs().max().item()
                   for n, g in grads[1].items())
    print(f'phase 15 engine schedule: step 1 at lr {sched(0)}, card against '
          f'CPU: loss {step1[0]:.7f} against {step1[1]:.7f}, gradients max '
          f'abs diff {grad_err:.3g}', flush=True)
    check(abs(step1[0] - step1[1]) <= GRAD_ATOL and grad_err <= GRAD_ATOL,
          f'step-1 loss and gradients within {GRAD_ATOL} of the CPU')
    del grads, m

    # schedules: 2 epochs of fit with a ValidationCallback every 10 steps
    save_dir = tempfile.mkdtemp()
    model = GraphConvModel(**kw, device=dev, seed=1)
    metric = Metric(roc_auc_score, np.mean)
    vc = ValidationCallback(valid, ENGINE_INTERVAL, [metric],
                            save_dir=save_dir, save_on_minimum=False)
    rates = []
    print('phase 15 engine schedule: validation lines:', flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_losses = []
    model.fit(ds, nb_epoch=2, checkpoint_interval=0, all_losses=fit_losses,
              callbacks=[lambda m, step: rates.append(
                  m._torch_optimizer.learning_rate()), vc])
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3 / (2 * S)
    used = [sched(0)] + rates[:-1]
    print(f'phase 15 engine schedule: fit, {2 * S} steps of {B} with '
          f'ExponentialDecay{ENGINE_SCHEDULE}, {fit_ms:.3f} ms a step with '
          f'{2 * S // ENGINE_INTERVAL} validations; rate of each step '
          f'{used}; loss per window '
          f'{[round(v, 5) for v in fit_losses]}; best ROC-AUC '
          f'{vc.get_best_score():.6f}', flush=True)
    check(rates == [sched(k) for k in range(1, 2 * S + 1)]
          and model._torch_optimizer.count == 2 * S,
          'each step at the schedule\'s rate of its update count')
    model.restore(model_dir=save_dir)
    best = model.evaluate(valid, [metric])['roc_auc_score']
    print(f'phase 15 engine schedule: the best checkpoint scores {best:.6f} '
          f'(logged {vc.get_best_score():.6f})', flush=True)
    check(best == vc.get_best_score(), 'the best checkpoint scores the '
          'logged best score')
    shutil.rmtree(save_dir, ignore_errors=True)

    # evaluation: evaluate_on_device against evaluate
    scores = [Metric(roc_auc_score, np.mean), Metric(prc_auc_score, np.mean),
              Metric(accuracy_score, np.mean)]
    by_batch = model.evaluate(valid, scores)
    t0 = time.perf_counter()
    on_device = model.evaluate_on_device(valid, scores)
    eval_ms = (time.perf_counter() - t0) * 1e3
    eval_err = max(abs(on_device[k] - by_batch[k]) for k in by_batch)
    print(f'phase 15 engine evaluate: evaluate_on_device '
          f'{json.dumps({k: float(v) for k, v in on_device.items()})} in '
          f'{eval_ms:.3f} ms, evaluate '
          f'{json.dumps({k: float(v) for k, v in by_batch.items()})}',
          flush=True)
    check(set(on_device) == set(by_batch) and eval_err <= SCORE_ATOL,
          f'evaluate_on_device within {SCORE_ATOL} of evaluate ({eval_err})')

    # reinitialize: a fresh model's parameters, bit for bit
    model.reinitialize(seed=3)
    fresh = GraphConvModel(**kw, device=dev, seed=3)
    differ = [n for (n, a), b in zip(model.module.state_dict().items(),
                                     fresh.module.state_dict().values())
              if not torch.equal(a, b)]
    check(not differ and model.get_global_step() == 0
          and model._torch_optimizer.count == 0,
          f'reinitialize(seed=3) equals a fresh model; differ: {differ}')
    epoch_ms = []
    for m in (model, fresh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.fit_on_device(ds, nb_epoch=1, seed=0)
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
    print(f'phase 15 engine reinitialize: equal to a fresh seed-3 model bit '
          f'for bit; a fit_on_device epoch of {S} steps {epoch_ms[0]:.1f} ms '
          f'after reinitialize (batches packed) against {epoch_ms[1]:.1f} ms '
          f'for a fresh model (packs and uploads)', flush=True)
    del fresh
    gc.collect()
    torch.cuda.empty_cache()

    # streaming: chunks of ENGINE_CHUNK batches against the resident epoch
    stack = model._host_stack(ds)
    epoch_bytes = sum(a.nbytes for part in stack for a in part)
    per_batch = epoch_bytes // S
    runs = []
    for kind in ('streamed', 'resident') * 2:      # in turns
        model.reinitialize(seed=4)
        model.device_data_budget = 2 * ENGINE_CHUNK * per_batch + 1 \
            if kind == 'streamed' else 2 << 30
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        t0 = time.perf_counter()
        out = []
        model.fit_on_device(ds, nb_epoch=2, seed=5, all_losses=out)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (2 * S)
        runs.append(dict(
            kind=kind, losses=out, ms=ms, base=base,
            peak=torch.cuda.max_memory_allocated(),
            launches={k: v - before[k] for k, v in launch_counts().items()},
            state={k: v.clone() for k, v in
                   model.module.state_dict().items()}))
    st, rs = runs[0], runs[1]
    chunk = ENGINE_CHUNK * per_batch
    work = rs['peak'] - rs['base']      # the step's own tensors, resident
    differ = [(r['kind'], k) for r in runs[1:]
              for k, v in r['state'].items() if not torch.equal(
                  v, st['state'][k])]
    held = max(r['peak'] - r['base'] for r in runs
               if r['kind'] == 'streamed')
    print(f'phase 15 engine streaming: {S} batches of {per_batch} bytes, '
          f'budget {2 * chunk + 1} bytes, chunks of {ENGINE_CHUNK}; epoch '
          f'losses streamed {st["losses"]}, resident {rs["losses"]}; '
          f'max_memory_allocated streamed {st["peak"]} (base {st["base"]}), '
          f'resident {rs["peak"]} (base {rs["base"]}, its epoch of '
          f'{epoch_bytes} bytes uploaded before); host ms a step in turns '
          f'{[(r["kind"], round(r["ms"], 3)) for r in runs]}', flush=True)
    check(all(r['losses'] == st['losses'] for r in runs) and not differ,
          f'streamed fit_on_device equals resident bit for bit; parameters '
          f'that differ: {differ}')
    check(all(r['launches'] == st['launches'] for r in runs),
          'the streamed runs launch what the resident runs do')
    check(held <= STREAM_MEMORY_SLACK * (2 * chunk + work),
          f'the streamed run holds at most 2 chunks and a step\'s tensors '
          f'(+{STREAM_MEMORY_SLACK - 1:.0%}): {held} > '
          f'{STREAM_MEMORY_SLACK} * ({2 * chunk} + {work})')
    del model, runs, st, rs
    gc.collect()
    torch.cuda.empty_cache()

    # uncertainty: MC dropout through the kernels and the plain versions
    unc = GraphConvModel(**dict(GRAPHCONV, mode='regression'),
                         uncertainty=True, dropout=0.2, device=dev, seed=6)
    unc_ds = NumpyDataset(X[:ENGINE_VALID], values)
    results = []
    for routed in (False, True):
        unc.module._dropout_generator = None        # the same masks
        with plain_routed() if routed else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results.append(unc.predict_uncertainty(
                unc_ds, masks=UNCERTAINTY_MASKS))
            torch.cuda.synchronize()
            results[-1] += ((time.perf_counter() - t0) * 1e3,)
    (pred, std, unc_ms), (pred_p, std_p, plain_ms) = results
    unc_err = max(scaled_err(torch.from_numpy(a), torch.from_numpy(b))
                  for a, b in ((pred, pred_p), (std, std_p)))
    forwards = UNCERTAINTY_MASKS * -(-ENGINE_VALID // B)
    print(f'phase 15 engine uncertainty: predict_uncertainty(masks='
          f'{UNCERTAINTY_MASKS}) over {ENGINE_VALID} molecules, {forwards} '
          f'forwards, {unc_ms:.1f} ms through the kernels, {plain_ms:.1f} ms '
          f'through the plain versions; max diff / max(1, |ref|) {unc_err:.3g}'
          f'; std {float(std.min()):.4g} to {float(std.max()):.4g}',
          flush=True)
    check(pred.shape == std.shape == (ENGINE_VALID, GRAPHCONV['n_tasks'])
          and bool(np.isfinite(pred).all()) and bool(np.isfinite(std).all())
          and bool((std > 0).all()), 'finite predictions, finite positive '
          'standard deviations')
    check(unc_err <= UNCERTAINTY_RTOL, f'kernels within {UNCERTAINTY_RTOL} '
          f'of the plain versions ({unc_err})')
    del unc
    launches = launch_counts()
    for k in ('nei_sum', 'nei_sum_bwd', 'nei_max_fwd', 'nei_max_bwd',
              'graph_max_pool_fwd', 'graph_max_pool_bwd', 'csr_segment_sum'):
        check(launches[k] > 0, f'phase 15 launched {k}')
    print(f'phase 15 engine: launches {launches}; '
          f'{time.perf_counter() - t_phase:.1f} s', flush=True)
    return launches


@contextlib.contextmanager
def coo_branch(cls):
    """``cls`` switched to its COO branch while the block runs, as the JAX
    package's tests switch it: the table flags set to False on the
    class."""
    flags = {'uses_edge_table': False} if cls.uses_edge_table else \
        {'uses_neighbor_table': False, 'uses_rev_slot': False}
    own = {k: cls.__dict__[k] for k in flags if k in cls.__dict__}
    for k, v in flags.items():
        setattr(cls, k, v)
    try:
        yield
    finally:
        for k in flags:
            if k in own:
                setattr(cls, k, own[k])
            else:
                delattr(cls, k)


def auc_tie_slack(y, card, cpu):
    """How far the mean ROC-AUC over tasks can move between a classifier's
    answers on the card and on the CPU that differ by at most ``d`` (the
    largest difference of a class-1 probability): a task's (positive,
    negative) pair whose CPU probabilities lie within ``2 d`` can rank the
    other way on the card, each worth ``1 / (P N)`` of its AUC.  Returns
    the mean over the tasks with both classes of that share of pairs, and
    ``d``."""
    import numpy as np
    p_card, p_cpu = card[..., 1], cpu[..., 1]
    d = float(np.abs(p_card - p_cpu).max())
    shares = []
    for t in range(y.shape[1]):
        pos, neg = p_cpu[y[:, t] == 1, t], p_cpu[y[:, t] == 0, t]
        if len(pos) and len(neg):
            close = np.abs(pos[:, None] - neg[None, :]) <= 2 * d
            shares.append(float(close.mean()))
    return (float(np.mean(shares)) if shares else 0.0), d


def cut_training(tag, make, X, y, dev, tb, smi, ids=None):
    """``model_phase``'s card-against-CPU training checks at batch ``tb``
    (its ``cpu_cut``): from seed 1, 2 epochs of one batch ``X[:tb]`` by
    ``fit`` (a loss a step) on the card and on the CPU, and by
    ``fit_on_device`` on the card (a loss an epoch: the same two steps;
    ``ids`` the samples' ids where given);
    each card loss within CPU_ATOL of max(1, |loss|) of the CPU's.
    Returns the step-1 gradients of the ``fit`` runs (card, CPU) and the
    largest loss difference."""
    import numpy as np
    from deepchem_tpu_torch import NumpyDataset
    data = NumpyDataset(X[:tb], y[:tb],
                        ids=None if ids is None else ids[:tb])
    grads, losses = [{}, {}], [[], [], []]
    for i, device in enumerate((dev, 'cpu')):
        m = make(device, 1, log_frequency=1, batch_size=tb)
        m.fit(data, nb_epoch=2, checkpoint_interval=0, deterministic=True,
              all_losses=losses[i], callbacks=step1_grads(grads[i]))
    make(dev, 1, batch_size=tb).fit_on_device(data, nb_epoch=2,
                                              all_losses=losses[2])
    err = max(abs(a - b) / max(1.0, abs(b)) for card in (losses[0],
                                                         losses[2])
              for a, b in zip(card, losses[1]))
    print(f'{tag} train ({smi}): at batch {tb}, 2 steps, card fit '
          f'{[round(v, 6) for v in losses[0]]}, fit_on_device '
          f'{[round(v, 6) for v in losses[2]]}, CPU fit '
          f'{[round(v, 6) for v in losses[1]]}, max diff over max(1, '
          f'|loss|) {err:.3g}', flush=True)
    check(all(len(v) == 2 for v in losses)
          and bool(np.all(np.isfinite(losses))) and err <= CPU_ATOL,
          f'{tag}: the card\'s losses at batch {tb} within {CPU_ATOL} of '
          f'the CPU\'s ({err})')
    return grads, err


def batch_loss(model, batch) -> float:
    """A pretraining or reconstruction model's score of one batch: its
    ``loss_func``, or its loss on the batch in ``eval()`` mode."""
    inputs, labels, weights = model._prepare_batch(batch)
    if hasattr(model, 'loss_func'):
        return model.loss_func(inputs, labels, weights).item()
    model.module.eval()
    return model._compute_loss(model._forward(inputs), labels,
                               weights).item()


def model_phase(phase, tag, make, X, y, per_batch, per_step, smi,
                scored=True, out_tail=(1,), metrics=None, on_device=None,
                score_rows=None, scaled=False, overfit_steps=50,
                loss_epochs=3, same_bits=False, cpu_cut=None,
                profile_calls=3, idle=(), grad_atol=GRAD_ATOL,
                grad_atol_of=None,
                timed_epochs=2, tie_slack=False, scorer=None,
                sample_outputs=False, ids=None):
    """Phases 13, 14, 16, 17 and 19: serves, trains and scores one
    model on the card, each held against the CPU: requests of REQUESTS
    molecules and the whole of ``X`` (CPU_ATOL), LATENCY_REQUESTS timed
    requests of 16 (median, p90), 3 ``fit`` epochs (the step time over the
    last 2, or over ``timed_epochs`` after the first) and 3
    ``fit_on_device`` epochs against the same on the CPU
    (per-epoch losses within CPU_ATOL relative; the step time over the
    last 2), the kernel
    launches of a forward batch (``per_batch``) and of a step
    (``per_step``, both training loops), step-1 gradients (``grad_atol``,
    GRAD_ATOL by default, of max(1, |g|), or the limit ``grad_atol_of``
    names for a parameter), a fixed batch that must overfit, and the
    score: with ``scored``, ``evaluate``'s pearson r2, RMS and MAE
    (EVAL_ATOL), else (a pretraining task, whose outputs are per-edge or
    per-node embeddings) ``loss_func`` on the first batch (EVAL_ATOL relative);
    then the card's busy µs and kernels of a request of 16 and of a
    training step.  ``make(device, seed, **kw)`` builds the model; a
    prediction is ``[n, *out_tail]``; ``metrics`` replaces the regression
    scores (a classifier's ROC-AUC), computed over the rows
    ``score_rows`` of ``X`` where given; ``fit_on_device`` trains on
    ``on_device`` (``(X, y)``) where given.  With ``scaled`` the answers
    are held within CPU_ATOL of max(1, |ref|) and the scores within
    EVAL_SCALED_RTOL of max(1, |score|) (a model whose activations reach
    tens to hundreds, where float32's rounding alone is about 1e-4 of an
    answer at its initial weights);
    the fixed batch gets ``overfit_steps`` steps to fall below 0.9 of its
    first loss; with ``same_bits`` two ``fit``s of 2 steps from one seed
    must give the same bits (:func:`fit_bits`); the first ``loss_epochs`` of fit_on_device's 3 epoch
    losses are held to the CPU's (a training run that a 1e-7 change of
    its weights moves by more than CPU_ATOL by its third epoch cannot be
    held to the CPU's there: scripts/materials_float32_drift.py).  With
    ``cpu_cut`` ``(sb, tb)`` (a model too wide for the host to follow at
    its batch) the card runs everything at the model's batch, and the CPU
    follows on small inputs: the requests against a CPU model of batch
    ``sb`` (its answers per molecule do not depend on the batch; the
    card's leading rows are compared where a pretraining output has more),
    the whole set's first ``sb`` predictions, 2 steps at batch ``tb`` from
    one seed (:func:`cut_training`; their step-1 gradients are the ones
    held), the fixed batch at ``tb``, and the score against a CPU model of
    batch ``sb`` with the trained weights (a pretraining task's
    ``loss_func`` on its first batch of ``sb`` on both devices).  The
    card's busy time is profiled over ``profile_calls`` calls a window,
    with the three device ops that take most of a step by name.
    ``scorer(model,
    dataset)`` (a dict of floats) replaces ``evaluate`` where given (a
    segmentation model's per-pixel scores).  A pretraining task (not
    ``scored``) is scored by its model's ``loss_func``, or with none by its
    loss on the batch in ``eval()`` mode; with ``sample_outputs`` its
    outputs have a row a sample, and a request's are its own rows.
    ``ids`` gives every dataset the phase builds from ``X`` its samples'
    ids (TextCNN reads its SMILES there).  The numbers include the
    card's peak memory over the phase, and that peak less what was
    allocated when it began.  Returns the launches of the
    serve, fit and fit_on_device runs and the numbers."""
    import numpy as np
    import torch
    from deepchem_tpu_torch import (Metric, NumpyDataset, mae_score,
                                    pearson_r2_score, rms_score)
    from deepchem_tpu_torch.utils.evaluate import _score
    head = f'phase {phase} {tag}'
    dev = torch.device('cuda', 0)
    clock = [time.perf_counter()]
    sections = {}

    def lap(name):
        now = time.perf_counter()
        sections[name] = round(now - clock[0], 2)
        clock[0] = now
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # by the phases before
    model = make(dev, 0)
    B = model.batch_size

    def subset(rows=slice(None)):
        """The dataset of ``X[rows]``, ``y[rows]`` (and ``ids[rows]``)."""
        return NumpyDataset(X[rows], y[rows],
                            ids=None if ids is None else ids[rows])
    ds = subset()

    def answer(m, Xs):
        """The model's answer to a request: its predictions, or for a
        pretraining task every output of the batch, untrimmed."""
        if scored:
            return [m.predict_on_batch(Xs)]
        out = m.predict_on_generator(m.default_generator(
            NumpyDataset(Xs), mode='predict'), output_types=['embedding'])
        out = out if isinstance(out, list) else [out]
        return [o[:len(Xs)] for o in out] if sample_outputs else out

    answer(model, X[:16])                                 # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    outs, request_ms, start = [], [], 0
    for n in REQUESTS:
        t0 = time.perf_counter()
        outs.append(answer(model, X[start:start + n]))
        request_ms.append((time.perf_counter() - t0) * 1e3)
        start += n
    serve = launch_counts()
    sb, tb = cpu_cut or (None, None)
    cpu = make('cpu', 0) if sb is None else make('cpu', 0, batch_size=sb)
    cpu.module.load_state_dict(
        {k: v.cpu() for k, v in model.module.state_dict().items()})
    def diff(a, b):
        scale = max(1.0, float(np.abs(b).max())) if scaled else 1.0
        if sb is not None:              # a batch of sb: the leading rows
            a = a[:len(b)]
        return float(np.abs(a - b).max()) / scale
    worst, start = 0.0, 0
    for n, out in zip(REQUESTS, outs):
        ref = answer(cpu, X[start:start + n])
        check(len(out) == len(ref) and all(
            (a.shape == b.shape if sb is None else
             a.shape[1:] == b.shape[1:] and len(a) >= len(b))
            and bool(np.isfinite(a).all())
            for a, b in zip(out, ref)), f'{tag} request of {n}: finite, '
              'the CPU run\'s shapes')
        check(not scored or out[0].shape == (n,) + tuple(out_tail),
              f'{tag} output [{n}, {out_tail}]')
        worst = max([worst] + [diff(a, b) for a, b in zip(out, ref)])
        start += n
    print(f'{head} serve ({smi}): requests {list(REQUESTS)} molecules, ms '
          f'per request {[round(t, 3) for t in request_ms]}; max abs diff '
          + ('over max(1, |ref|) ' if scaled else '')
          + f'against the CPU run {worst:.3g}; launches {serve}', flush=True)
    check(worst <= CPU_ATOL, f'{tag} card vs CPU {worst} > {CPU_ATOL}')
    for k, v in serve.items():
        want = per_batch.get(k, 0) * len(REQUESTS)
        check(v == want, f'{tag} serve: {k} launched {v} times, not {want}')
    t0 = time.perf_counter()
    every = answer(model, X)
    predict_ms = (time.perf_counter() - t0) * 1e3
    if sb is None:
        predict_err = max(diff(a, b) for a, b in zip(every, answer(cpu, X)))
    elif scored:
        predict_err = diff(every[0][:sb], answer(cpu, X[:sb])[0])
    else:                   # the requests held every pretraining output
        predict_err = 0.0
    check(all(bool(np.isfinite(a).all()) for a in every)
          and predict_err <= CPU_ATOL,
          f'{tag} predict over {len(X)}: finite, within {CPU_ATOL} of the '
          f'CPU ({predict_err})')
    latency = []
    for i in range(LATENCY_REQUESTS):
        lo = (16 * i) % (len(X) - 16)
        t0 = time.perf_counter()
        answer(model, X[lo:lo + 16])
        latency.append((time.perf_counter() - t0) * 1e3)
    p50, p90 = (float(v) for v in np.percentile(latency, [50, 90]))
    print(f'{head} serve ({smi}): all {len(X)} molecules in '
          f'{predict_ms:.3f} ms, within {predict_err:.3g} of the CPU; '
          f'{LATENCY_REQUESTS} requests of 16 molecules: median {p50:.3f} '
          f'ms, p90 {p90:.3f} ms', flush=True)

    lap('serve')
    # training: fit, then fit_on_device, 3 epochs each
    runs = {}
    for loop in ('fit', 'fit_on_device'):
        data = ds if loop == 'fit' or on_device is None \
            else NumpyDataset(*on_device)
        S = -(-len(data) // B)
        trainer = make(dev, 1, log_frequency=S)
        torch.cuda.synchronize()
        reset_launch_counts()
        losses = []

        def train(epochs, m=trainer, out=losses):
            if loop == 'fit':
                m.fit(data, nb_epoch=epochs, checkpoint_interval=0,
                      all_losses=out)
            else:
                m.fit_on_device(data, nb_epoch=epochs, all_losses=out)
        train(1)                                  # packs, warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train(timed_epochs)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (timed_epochs * S)
        counts = launch_counts()
        steps = trainer.get_global_step()
        cpu_losses = []
        if loop == 'fit_on_device' and sb is None:
            cpu_t = make('cpu', 1, log_frequency=S)
            cpu_t.fit_on_device(data, nb_epoch=1, all_losses=cpu_losses)
            cpu_t.fit_on_device(data, nb_epoch=2, all_losses=cpu_losses)
        loss_err = max((abs(a - b) / max(1.0, abs(b)) for a, b in zip(
            losses[:loss_epochs], cpu_losses[:loss_epochs])), default=0.0)
        print(f'{head} train ({smi}): {loop}, {steps} steps of {B} '
              f'molecules over {len(data)}, {step_ms:.3f} ms a step over '
              f'the last {timed_epochs} epoch(s); '
              f'loss per epoch {[round(v, 5) for v in losses]}'
              + (f', on the CPU {[round(v, 5) for v in cpu_losses]}'
                 if cpu_losses else '') + f'; launches {counts}',
              flush=True)
        epochs = 1 + timed_epochs
        check(steps == epochs * S and len(losses) == epochs
              and bool(np.all(np.isfinite(losses))),
              f'{tag} {loop}: {epochs * S} steps, {epochs} finite epoch '
              'losses')
        check(loss_err <= CPU_ATOL, f'{tag} {loop}: epoch losses '
              f'{loss_err} of max(1, |loss|) from the CPU\'s (first '
              f'{loss_epochs})')
        for k, v in counts.items():
            want = per_step.get(k, 0) * steps
            check(v == want,
                  f'{tag} {loop}: {k} launched {v} times, not {want}')
        runs[loop] = (counts, step_ms, trainer)

    lap('train')
    # step-1 gradients, card against CPU, from the same weights
    grads = []
    if sb is not None:
        grads, cut_err = cut_training(tag, make, X, y, dev, tb, smi, ids)
    for device in (dev, 'cpu') if sb is None else ():
        m = make(device, 0, log_frequency=1)
        m.module.load_state_dict({k: v.to(device) for k, v in
                                  model.module.state_dict().items()})
        grads.append({})
        m.fit(subset(slice(B)), nb_epoch=1, checkpoint_interval=0,
              callbacks=step1_grads(grads[-1]))
    check(set(grads[0]) == set(grads[1]), f'{tag}: the card and the CPU '
          'give the same parameters a gradient')
    names = [n for n, _ in model.module.named_parameters()]
    without = sorted(set(names) - set(grads[0]))
    check(without == sorted(n for n in names
                            if any(n.startswith(p) for p in idle)),
          f'{tag}: the parameters with no gradient are the idle ones: '
          f'{without}')
    errs = {n: scaled_err(grads[0][n], g) for n, g in grads[1].items()}
    grad_err = max(errs.values())
    own = grad_atol_of or {}
    check(set(own) <= set(errs), f'{tag}: the parameters with limits of '
          f'their own are the model\'s: {sorted(own)}')
    over = {n: e for n, e in errs.items() if e > own.get(n, grad_atol)}
    zero = [n for n, g in grads[0].items() if not g.abs().max() > 0]
    print(f'{head} train: step-1 gradients, card against CPU, max abs '
          f'diff over max(1, |g|) {grad_err:.3g} over {len(grads[1])} '
          f'parameters'
          + ''.join(f'; {n} {errs[n]:.3g} (its limit {v:.3g}), the rest '
                    f'{max(e for k, e in errs.items() if k not in own):.3g}'
                    for n, v in own.items())
          + f'; zero gradients: {zero}; none (idle): {len(without)}',
          flush=True)
    check(not over, f'{tag} step-1 gradients over {grad_atol} of max(1, '
          f'|g|) (or their own limit): {over}')
    check(not zero, f'{tag}: every parameter gets a gradient; zero: {zero}')
    del grads
    lap('grads')
    if same_bits:
        differ, n_params = fit_bits(make, X, y, dev, ids=ids)
        print(f'{head} train: two fits of 2 steps from seed 0 on the card, '
              f'every gradient and weight of {n_params} parameters the same '
              f'bits: {not differ}; differing: {differ}', flush=True)
        check(not differ, f'{tag}: two fits from one seed differ in '
              f'{differ}')
    lap('same_bits')
    if overfit_steps:
        overfit = make(dev, 2, log_frequency=1) if sb is None \
            else make(dev, 2, log_frequency=1, batch_size=tb)
        fixed = []
        OB = overfit.batch_size
        overfit.fit(subset(slice(OB)), nb_epoch=overfit_steps,
                    checkpoint_interval=0, all_losses=fixed)
        below = next((i + 1 for i, v in enumerate(fixed)
                      if v < 0.9 * fixed[0]), None)
        print(f'{head} train: one fixed batch of {OB}, lr '
              f'{overfit.optimizer.learning_rate}: loss '
              f'{fixed[0]:.5f} at step 1, {min(fixed):.5f} at best, below '
              f'0.9 of the first at step {below}', flush=True)
        check(below is not None, f'{tag}: the loss falls below 0.9 of its '
              f'first value within {overfit_steps} steps')
        del overfit
    lap('overfit')
    # scoring
    trainer = runs['fit'][2]
    cpu.module.load_state_dict(
        {k: v.cpu() for k, v in trainer.module.state_dict().items()})
    t0 = time.perf_counter()
    if scored:
        metrics = metrics or [Metric(pearson_r2_score), Metric(rms_score),
                              Metric(mae_score)]
        scored_ds = ds if score_rows is None else subset(score_rows)
        scores = scorer(trainer, scored_ds) if scorer else \
            trainer.evaluate(scored_ds, metrics)
        eval_ms = (time.perf_counter() - t0) * 1e3
        if scorer:
            cpu_scores = scorer(cpu, scored_ds)
        elif tie_slack:           # the CPU's predictions, scored as evaluate
            cpu_pred = cpu.predict(scored_ds)
            cpu_scores = _score(metrics, scored_ds.y, cpu_pred, scored_ds.w,
                                False, n_classes=2, use_sample_weights=False)
            slack, tie_d = auc_tie_slack(
                scored_ds.y, trainer.predict(scored_ds), cpu_pred)
            # the slack grows with the answers' difference: that is held
            # to the answers' own limit first, and the slack capped
            check(tie_d <= CPU_ATOL, f'{tag}: the trained model\'s '
                  f'probabilities on the card {tie_d} from the CPU\'s > '
                  f'{CPU_ATOL}')
            check(slack <= AUC_SLACK_MAX, f'{tag}: ROC-AUC tie slack '
                  f'{slack} > {AUC_SLACK_MAX}')
        else:
            cpu_scores = cpu.evaluate(scored_ds, metrics)
        eval_err = max(abs(scores[k] - cpu_scores[k])
                       / (max(1.0, abs(cpu_scores[k])) if scaled else 1.0)
                       for k in cpu_scores)
    else:
        card = trainer
        if sb is not None:      # the first batch of sb on both devices
            card = make(dev, 0, batch_size=sb)
            card.module.load_state_dict(trainer.module.state_dict())
        first = [next(m.default_generator(ds)) for m in (card, cpu)]
        scores, cpu_scores = ({'loss_func': batch_loss(m, b)}
                              for m, b in zip((card, cpu), first))
        eval_ms = (time.perf_counter() - t0) * 1e3
        eval_err = abs(scores['loss_func'] - cpu_scores['loss_func']) / max(
            1.0, abs(cpu_scores['loss_func']))
    eval_tol = EVAL_SCALED_RTOL if scaled else EVAL_ATOL
    if scored and tie_slack:
        eval_tol += slack
    print(f'{head} evaluate ({smi}): {json.dumps(scores)} on the card in '
          f'{eval_ms:.3f} ms, {json.dumps(cpu_scores)} on the CPU'
          + (f'; ROC-AUC tie slack {slack:.3g} from probabilities '
             f'{tie_d:.3g} apart' if scored and tie_slack else ''),
          flush=True)
    check(set(scores) == set(cpu_scores) and eval_err <= eval_tol
          and all(np.isfinite(v) for v in scores.values()),
          f'{tag} score finite and within {eval_tol} of the CPU '
          f'({eval_err})')

    lap('score')
    # the card's busy time: every kernel, memset and copy of a call
    serve_us, serve_kernels = device_us_all(lambda: answer(model, X[:16]),
                                            calls=profile_calls)
    step_data = subset(slice(B))
    step_us, step_kernels, step_top = device_us_all(
        lambda: trainer.fit(step_data, nb_epoch=1, checkpoint_interval=0),
        calls=profile_calls, top=3)
    numbers = {'request16_median_ms': p50, 'request16_p90_ms': p90,
               'fit_step_ms': runs['fit'][1],
               'fit_on_device_step_ms': runs['fit_on_device'][1],
               'request16_device_us': serve_us,
               'request16_device_kernels': serve_kernels,
               'step_device_us': step_us, 'step_device_kernels': step_kernels,
               'step_top_device_us': step_top,
               'max_request_err': worst, 'step1_grad_err': grad_err,
               'eval_err': eval_err, 'same_bits_checked': same_bits,
               'cpu_cut': cpu_cut,
               'cut_loss_err': cut_err if sb is not None else None,
               'seconds': (lap('profile'), sections)[1],
               'peak_memory_bytes': torch.cuda.max_memory_allocated(),
               'peak_over_held_bytes': torch.cuda.max_memory_allocated()
               - held}
    print(f'{head} card: {json.dumps(numbers)}', flush=True)
    return serve, runs['fit'][0], runs['fit_on_device'][0], numbers


def table_vs_coo(tag, cls, make, X):
    """Phase 17: one model's predictions over ``X`` on the card through its
    table path and, from the same weights, through its COO branch, within
    COO_RTOL and COO_ATOL."""
    import numpy as np
    import torch
    from deepchem_tpu_torch import NumpyDataset
    model = make(torch.device('cuda', 0), 0)
    table = model.predict(NumpyDataset(X))
    with coo_branch(cls):
        coo = model.predict(NumpyDataset(X))
    err = float(np.abs(coo - table).max())
    print(f'phase 17 {tag}: COO branch against the table path on the card '
          f'over {len(X)} molecules, max abs diff {err:.3g}', flush=True)
    check(bool(np.isfinite(coo).all()) and np.allclose(
        coo, table, rtol=COO_RTOL, atol=COO_ATOL),
          f'{tag}: COO branch within rtol {COO_RTOL}, atol {COO_ATOL} of '
          f'the table path ({err})')
    return err


def dense_data():
    """Phase 18's molecules: the 48 SMILES repeated and shuffled from a
    seed to DENSE_MOLECULES, as ``CircularFingerprint(size=FP_BITS)``
    (timed a molecule), with seeded 0/1 and normal labels, and the rows
    of each SMILES's first copy: the set that is scored, since a score
    that ranks (ROC-AUC) breaks the ties of equal molecules by the last
    bit of each, which the card's GEMMs round by the row's place in its
    batch."""
    import numpy as np
    from deepchem_tpu_torch.feat import CircularFingerprint
    order = np.random.RandomState(0).permutation(
        np.resize(np.arange(len(SMILES)), DENSE_MOLECULES))
    smiles = [SMILES[i] for i in order]
    t0 = time.perf_counter()
    X = CircularFingerprint(size=FP_BITS).featurize(smiles)
    per_mol_ms = (time.perf_counter() - t0) * 1e3 / len(smiles)
    check(X.shape == (DENSE_MOLECULES, FP_BITS) and X.any(axis=1).all(),
          'every molecule has a fingerprint')
    labels = np.random.RandomState(1).randint(
        0, 2, (DENSE_MOLECULES, DENSE_TASKS)).astype(np.float32)
    values = np.random.RandomState(2).randn(
        DENSE_MOLECULES, DENSE_TASKS).astype(np.float32)
    first = np.unique(order, return_index=True)[1]
    return X.astype(np.float32), labels, values, per_mol_ms, first


def dense_phase(tag, make, ds, score, featurize_ms, smi, epochs=3):
    """Phase 18: one fingerprint model, card and CPU from the same weights.
    Requests of 16 samples against the CPU (CPU_ATOL) and
    LATENCY_REQUESTS of them timed (median, p90); ``epochs`` of ``fit``
    (the step time over all but the first, losses finite); then
    ``score(model)`` (a dict of floats) on the card against the CPU within
    EVAL_ATOL.  ``make(device)`` builds the model with seed 0."""
    import numpy as np
    import torch
    dev = torch.device('cuda', 0)
    t_phase = time.perf_counter()
    model, cpu = make(dev), make('cpu')
    models = getattr(model, 'models', [model])
    for m, c in zip(models, getattr(cpu, 'models', [cpu])):
        c.module.load_state_dict(
            {k: v.cpu() for k, v in m.module.state_dict().items()})
    X = ds.X

    def flat(out):
        return [np.asarray(o) for o in (out if isinstance(out, list)
                                        else [out])]
    flat(model.predict_on_batch(X[:16]))                  # warm-up
    worst, latency = 0.0, []
    for i in range(LATENCY_REQUESTS):
        lo = (16 * i) % (len(X) - 16)
        t0 = time.perf_counter()
        out = flat(model.predict_on_batch(X[lo:lo + 16]))
        latency.append((time.perf_counter() - t0) * 1e3)
        if i < 3:
            ref = flat(cpu.predict_on_batch(X[lo:lo + 16]))
            check(all(a.shape == b.shape and bool(np.isfinite(a).all())
                      for a, b in zip(out, ref)),
                  f'{tag} request: finite, the CPU run\'s shapes')
            worst = max([worst] + [float(np.abs(a - b).max())
                                   for a, b in zip(out, ref)])
    check(worst <= CPU_ATOL, f'{tag} card vs CPU {worst} > {CPU_ATOL}')
    p50, p90 = (float(v) for v in np.percentile(latency, [50, 90]))
    losses = []
    torch.cuda.synchronize()
    t0 = t1 = time.perf_counter()
    for e in range(epochs):
        if e == 1:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        losses.append(model.fit(ds, nb_epoch=1, checkpoint_interval=0))
    torch.cuda.synchronize()
    steps = sum(m.get_global_step() for m in models)
    step_ms = (time.perf_counter() - t1) * 1e3 / max(
        1, steps * (epochs - 1) // epochs)
    check(all(np.isfinite(v) for v in losses if v is not None),
          f'{tag}: finite losses {losses}')
    for m, c in zip(models, getattr(cpu, 'models', [cpu])):
        c.module.load_state_dict(
            {k: v.cpu() for k, v in m.module.state_dict().items()})
    scores, cpu_scores = score(model), score(cpu)
    err = max(abs(scores[k] - cpu_scores[k]) for k in cpu_scores)
    numbers = {'featurize_ms_per_molecule': featurize_ms,
               'request16_median_ms': p50, 'request16_p90_ms': p90,
               'max_request_err': worst, 'fit_steps': steps,
               'fit_step_ms': step_ms, 'epoch_losses': losses,
               'scores': scores, 'cpu_scores': cpu_scores, 'eval_err': err,
               'phase_s': time.perf_counter() - t_phase}
    print(f'phase 18 {tag} ({smi}): {json.dumps(numbers)}', flush=True)
    check(all(np.isfinite(v) for v in scores.values()) and err <= EVAL_ATOL,
          f'{tag}: scores finite and within {EVAL_ATOL} of the CPU ({err})')
    return numbers


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    if not (REPO / 'deepchem_tpu_torch' / '__init__.py').is_file():
        print('chip_smoke: the deepchem_tpu_torch package is missing beside '
              'this script', file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import numpy as np
    warnings.filterwarnings('ignore', message='Sparse CSR tensor support')

    # -- 1. device --------------------------------------------------------
    phase_start(1)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    name = torch.cuda.get_device_name(0)
    print(f'phase 1 device: {name}; torch {torch.__version__}, cuda '
          f'{torch.version.cuda}; tf32 off', flush=True)

    # -- 2. build ---------------------------------------------------------
    phase_start(2)
    from deepchem_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    for kname in build.kernel_names():
        build.load(kname)
    print(f'phase 2 build: {len(build.kernel_names())} kernel(s) in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    check(len(build.kernel_names()) == 7, 'seven kernel sources to build')
    for kname in build.kernel_names():
        ptxas = [ln.strip() for ln in build.build_log(kname).splitlines()
                 if 'registers' in ln or 'spill' in ln]
        print(f'phase 2 build {kname}: {" | ".join(ptxas)}', flush=True)
    # ptxas reports a wgmma it had to serialise only as an info line
    check('C7512' not in build.build_log('flash_attention'),
          'ptxas serialised no wgmma of the bf16 flash kernels (C7512)')
    for kname in ('nei_table', 'graph_pool', 'nei_gather',
                  'fused_gather_segment_sum'):
        spills = [int(n) for n in re.findall(
            r'(\d+) bytes spill (?:stores|loads)', build.build_log(kname))]
        check(spills and not any(spills),
              f'ptxas reports no spill in {kname}.cu: {spills}')

    # -- featurize the main path's molecules (host work) -------------------
    from deepchem_tpu_torch import (NumpyDataset, PagtnModel,
                                    PagtnMolGraphFeaturizer)
    from deepchem_tpu_torch.models import graph_models
    from deepchem_tpu_torch.ops import (NEG, csr_segment, csr_segment_softmax,
                                        flash_attention,
                                        fused_gather_segment_sum,
                                        graph_max_pool, nei_gather,
                                        nei_max_incl_self, nei_sum, segment)
    from deepchem_tpu_torch.ops.nei_table import (float4_launches,
                                                  nei_gather_float4_launches)
    from deepchem_tpu_torch.ops.segment import graph_max_pool_float4_launches
    t0 = time.perf_counter()
    X = PagtnMolGraphFeaturizer().featurize(SMILES)
    sizes = [g.num_nodes for g in X if hasattr(g, 'num_nodes')]
    check(len(sizes) == len(SMILES), 'every molecule featurizes')
    check(min(sizes) >= 5 and max(sizes) <= 40, 'molecules of 5-40 atoms')
    print(f'featurized {len(X)} molecules of {min(sizes)}-{max(sizes)} '
          f'heavy atoms in {time.perf_counter() - t0:.2f} s', flush=True)
    labels = np.random.RandomState(0).randint(0, 2, (len(X), 12)).astype(
        np.float32)
    weights = np.ones_like(labels)
    model = PagtnModel(n_tasks=12, mode='classification', device=dev,
                       seed=0)
    n_layers = len(model.module.layers)

    # -- 3. kernels against their plain versions --------------------------
    phase_start(3)
    # the inputs the model hands the wrappers in one batch of 16
    batch16 = X[1:17]
    softmax_in = recorded(segment, 'csr_segment_softmax',
                          lambda: model.predict_on_batch(batch16))
    agg_in = recorded(graph_models, 'csr_segment_sum',
                      lambda: model.predict_on_batch(batch16))
    probe = PagtnModel(n_tasks=12, mode='classification', device=dev,
                       seed=0)
    backward_in = recorded(csr_segment, 'csr_segment_sum',
                           lambda: probe.fit_on_batch(
                               batch16, labels[1:17], weights[1:17]))
    del probe
    for what, seen in (('softmax', softmax_in), ('aggregation', agg_in),
                       ('softmax backward sum', backward_in)):
        check(len(seen) == n_layers,
              f'{len(seen)} {what} calls for {n_layers} layers')

    softmax_cases = [softmax_case('pagtn_batch16_layer0', *softmax_in[0])]
    rng = np.random.RandomState(0)
    E, H, N = 16384, 8, 2048
    dst = np.sort(rng.randint(0, N, E))
    row_ptr = np.searchsorted(dst, np.arange(N + 1)).astype(np.int32)
    softmax_cases.append(softmax_case(
        'wide_E16384_H8',
        torch.from_numpy(rng.randn(E, H).astype(np.float32)).to(dev),
        torch.from_numpy(row_ptr).to(dev)))
    # segments: empty, one edge, 40 edges, all NEG, empty tail; one head
    # all -inf in the 40-edge segment
    counts = [0, 1, 40, 0, 7, 1, 0, 33, 0, 0]
    edge_logits = rng.randn(sum(counts), 4).astype(np.float32) * 30
    rp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    edge_logits[rp[4]:rp[5]] = NEG
    edge_logits[rp[2]:rp[3], 2] = -np.inf
    edge_l, edge_rp = (torch.from_numpy(edge_logits).to(dev),
                       torch.from_numpy(rp).to(dev))
    softmax_cases.append(softmax_case('edge_segments', edge_l, edge_rp))
    # a ghost-sized segment of 1536 edges after 300 short ones, and one of
    # 40 000 edges among 511 short ones: the kernel splits both across a
    # block
    for short, long_len in ((300, 1536), (511, 40000)):
        lengths = list(rng.randint(0, 34, short)) + [long_len]
        long_rp = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
        softmax_cases.append(softmax_case(
            f'long_segment_{long_len}_H1',
            torch.from_numpy(rng.randn(int(long_rp[-1]), 1).astype(
                np.float32)).to(dev), torch.from_numpy(long_rp).to(dev)))
    y = csr_segment_softmax(edge_l, edge_rp).cpu().numpy()
    check(np.allclose(y[rp[4]:rp[5]], 1 / 7, atol=KERNEL_ATOL),
          'an all-NEG segment gives 1/count')
    check(np.all(y[rp[2]:rp[3], 2] == 0), 'an all -inf head gives 0')
    check(np.allclose(y[rp[1]], 1.0), 'a one-edge segment gives 1')
    backward_cases = [
        softmax_grad_case('pagtn_batch16_layer0', *softmax_in[0]),
        softmax_grad_case('edge_segments', edge_l, edge_rp)]

    sum_cases = [sum_case('pagtn_batch16_aggregation', *agg_in[0]),
                 sum_case('pagtn_batch16_softmax_backward',
                          *backward_in[0])]
    check(tuple(agg_in[0][0].shape) == (6144, 32)
          and tuple(backward_in[0][0].shape) == (6144, 1),
          'P3 shapes on the path: [6144, 32] and [6144, 1]')
    E, F, N = 32768, 512, 8192
    wide_rp = np.searchsorted(np.sort(rng.randint(0, N, E)),
                              np.arange(N + 1)).astype(np.int32)
    sum_cases.append(sum_case(
        'wide_E32768_F512',
        torch.from_numpy(rng.randn(E, F).astype(np.float32)).to(dev),
        torch.from_numpy(wide_rp).to(dev)))
    # a segment of 40 000 edges among 511 short ones, which the kernel
    # splits across a block, at F 32 (float4) and F 1
    lengths = list(rng.randint(0, 8, 511)) + [40000]
    long_rp = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])
                               .astype(np.int32)).to(dev)
    for F in (32, 1):
        sum_cases.append(sum_case(
            f'long_segment_40000_F{F}',
            torch.from_numpy(rng.randn(int(long_rp[-1]), F).astype(
                np.float32)).to(dev), long_rp))
    # the segments of the softmax edge case, 5 more edges past row_ptr[N]
    E_edge = int(rp[-1]) + 5
    for F in (37, 3):
        sum_cases.append(sum_case(
            f'edge_segments_F{F}',
            torch.from_numpy(rng.randn(E_edge, F).astype(np.float32)).to(dev),
            edge_rp))
    flat = torch.from_numpy(rng.randn(E_edge * 8 + 1).astype(np.float32))
    sum_cases.append(sum_case('edge_segments_F8_unaligned',
                              flat.to(dev)[1:].view(E_edge, 8), edge_rp))

    gather_cases = [gather_case(f'bench_N{n}_E{e}_F{f}',
                                *bench_graph(rng, n, e, f, dev))
                    for n, e, f in P2_BENCH_SHAPES]
    # tests/test_pallas_ops.py test_empty_segments: edges into 3 and 7 only
    h = torch.ones(16, 8, device=dev)
    src = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)
    empty_rp = torch.tensor([0, 0, 0, 0, 2, 2, 2, 2] + [3] * 9,
                            dtype=torch.int32, device=dev)
    gather_cases.append(gather_case('empty_segments', h, src, empty_rp))
    out = fused_gather_segment_sum(h, src, empty_rp).cpu().numpy()
    check(np.allclose(out[3], 2.0) and np.allclose(out[7], 1.0)
          and np.all(out[[0, 1, 2, 4, 5, 6] + list(range(8, 16))] == 0),
          'P2 sums two rows into node 3, one into 7, zeros elsewhere')
    # P2 on long segments split across its block: a hub, and a ghost-like
    # segment of P2_LONG_EDGES edge rows
    p2_long_cases = [gather_case(k, *a)
                     for k, a in p2_long_inputs(dev).items()]

    # P2's path: its entry point once at each bench shape
    p2_inputs = [bench_graph(rng, n, e, f, dev)
                 for n, e, f in P2_BENCH_SHAPES]
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.no_grad():
        p2_outs = [fused_gather_segment_sum(*a) for a in p2_inputs]
    torch.cuda.synchronize()
    p2_path = launch_counts()
    print(f'phase 3 p2 path: {len(p2_outs)} calls at the bench shapes, '
          f'launches {p2_path}', flush=True)
    check(p2_path['fused_gather_segment_sum'] == len(P2_BENCH_SHAPES),
          'P2 launched once per bench shape')
    for (h, _, rp_), o in zip(p2_inputs, p2_outs):
        check(tuple(o.shape) == (rp_.shape[0] - 1, h.shape[1])
              and bool(torch.isfinite(o).all()), 'P2 outputs finite')
    # P2 in bfloat16, as scripts/bench_pallas_csr.py runs it: each bench
    # shape, then the one-value-a-lane path (F 37, and F 64 off 16-byte
    # alignment), the long segments of p2_long_inputs (summed by the block,
    # bound by their order chain; the plain version's slot-by-slot loop
    # runs once there) and values that are not finite, aligned and not
    add_ns = bf16_add_ns(dev)
    bf16_inputs = [bench_graph(rng, n, e, f, dev)
                   for n, e, f in P2_BENCH_SHAPES]
    bf16_cases = [gather_bf16_case(f'bench_N{n}_E{e}_F{f}_bf16',
                                   h.to(torch.bfloat16), src, rp_, add_ns)
                  for (n, e, f), (h, src, rp_) in zip(P2_BENCH_SHAPES,
                                                      bf16_inputs)]
    h, src, rp_ = bench_graph(rng, 2048, 4096, 37, dev)
    bf16_cases.append(gather_bf16_case('F37_bf16', h.to(torch.bfloat16),
                                       src, rp_, add_ns))
    h, src, rp_ = bench_graph(rng, 2048, 4096, 64, dev)
    flat = torch.empty(h.numel() + 1, dtype=torch.bfloat16, device=dev)
    flat[1:] = h.reshape(-1).to(torch.bfloat16)
    bf16_cases.append(gather_bf16_case('F64_unaligned_bf16',
                                       flat[1:].view(h.shape), src, rp_,
                                       add_ns))
    bf16_cases += [gather_bf16_case(f'{k}_bf16', h.to(torch.bfloat16), src,
                                    rp_, add_ns, plain_iters=1)
                   for k, (h, src, rp_) in p2_long_inputs(dev).items()]
    bf16_cases += [gather_bf16_case(
        f'non_finite_F{f}{"" if aligned else "_unaligned"}_bf16',
        *p2_bf16_non_finite_inputs(dev, f, aligned), add_ns, plain_iters=3)
        for f, aligned in ((64, True), (64, False), (37, True))]
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.no_grad():
        bf16_outs = [fused_gather_segment_sum(h.to(torch.bfloat16), src, rp_)
                     for h, src, rp_ in bf16_inputs]
    torch.cuda.synchronize()
    p2_bf16_path = launch_counts()
    print(f'phase 3 p2 bf16 path: {len(bf16_outs)} calls at the bench '
          f'shapes, launches {p2_bf16_path}', flush=True)
    check(p2_bf16_path['fused_gather_segment_sum_bf16']
          == len(P2_BENCH_SHAPES)
          and p2_bf16_path['fused_gather_segment_sum'] == 0,
          'P2 bf16 launched once per bench shape, the f32 kernel never')
    check(all(o.dtype == torch.bfloat16 and bool(torch.isfinite(o).all())
              for o in bf16_outs), 'P2 bf16 outputs finite, in bf16')

    # K1-K3 at the inputs GraphConvModel hands them in phase 11's first
    # batch of 256, then at edge cases
    from deepchem_tpu_torch import GraphConvModel
    from deepchem_tpu_torch.models import graph_layers
    gc_X, gc_labels = graphconv_data()
    gc_model = GraphConvModel(**GRAPHCONV, device=dev, seed=0)
    gc_batch = gc_X[:GRAPHCONV['batch_size']]
    gc_sum_in = recorded(graph_layers, 'nei_sum',
                         lambda: gc_model.predict_on_batch(gc_batch))
    gc_max_in = recorded(graph_layers, 'nei_max_incl_self',
                         lambda: gc_model.predict_on_batch(gc_batch))
    gc_pool_in = recorded(segment, 'graph_max_pool',
                          lambda: gc_model.predict_on_batch(gc_batch))
    n_gc_layers = len(GRAPHCONV['graph_conv_layers'])
    check(len(gc_sum_in) == len(gc_max_in) == n_gc_layers
          and len(gc_pool_in) == 1, 'K1 and K2 once a layer, K3 once')
    check([a[0].shape[1] for a in gc_sum_in] == [75, 64]
          and gc_pool_in[0][0].shape[1] == GRAPHCONV['dense_layer_size'],
          'K1 at F 75 and 64, K3 at F 128 on the path')
    # K1 from MPNN's edge rows, P1 and P3 in its readout, at the inputs
    # MPNNModel hands them in phase 12's first batch of 100
    from deepchem_tpu_torch import MPNNModel
    mp_X, mp_y = mpnn_data()
    mp_model = MPNNModel(**MPNN, device=dev, seed=0)
    mp_batch = mp_X[:mp_model.batch_size]

    def mp_inputs(module, attr):
        return recorded(module, attr,
                        lambda: mp_model.predict_on_batch(mp_batch))
    mp_sum_in = mp_inputs(graph_layers, 'nei_sum_edges')
    mp_take_in = mp_inputs(graph_layers, 'take_src')
    mp_softmax_in = mp_inputs(segment, 'csr_segment_softmax')
    mp_readout_in = mp_inputs(graph_layers, 'csr_segment_sum')
    T, M = mp_model.module.mpnn.n_steps, mp_model.module.set2set.n_steps
    check(len(mp_sum_in) == len(mp_take_in) == T
          and len(mp_softmax_in) == len(mp_readout_in) == M,
          'MPNN: K1 and take_src once a message step, P1 and P3 once a '
          'set2set step')
    softmax_cases.append(softmax_case('mpnn_batch100_set2set',
                                      *mp_softmax_in[0]))
    sum_cases.append(sum_case('mpnn_batch100_set2set_readout',
                              *mp_readout_in[0]))
    gen = torch.Generator(dev).manual_seed(2)
    carry, esrc, o_table, o_deg = mp_take_in[0]
    mp_nei_cases = [
        nei_sum_case('mpnn_batch100_nei_sum_edges', *mp_sum_in[0][:3]),
        nei_sum_case('mpnn_batch100_take_src_bwd', torch.randn(
            (esrc.shape[0], carry.shape[1]), generator=gen, device=dev),
            o_table, o_deg)]
    check(all(c['F'] == 64 and c['R'] != c['N'] for c in mp_nei_cases),
          'MPNN: K1 from [E, 64] edge rows into N nodes')
    # the C entries of K1, K2 and K3 count their float4 launches
    paths_before = ((nei_sum.launches, nei_max_incl_self.backward_launches,
                     nei_max_incl_self.launches, graph_max_pool.launches,
                     graph_max_pool.backward_launches),
                    float4_launches() + graph_max_pool_float4_launches())
    nei_cases = [nei_sum_case(f'graphconv_batch256_layer{i}', *a)
                 for i, a in enumerate(gc_sum_in)] + mp_nei_cases
    max_cases = [nei_max_cases(f'graphconv_batch256_layer{i}', *a,
                               torch.randn(a[0].shape, generator=gen,
                                           device=dev))
                 for i, a in enumerate(gc_max_in)]
    x, rp_, mask_ = gc_pool_in[0]
    pool_cases = [graph_max_cases(
        'graphconv_batch256_readout', x, rp_, mask_,
        torch.randn((rp_.shape[0] - 1, x.shape[1]), generator=gen,
                    device=dev))]
    # degrees 0 to 10 (a node with ten neighbours); integer values in
    # 0..2, half of them zeros, so most maxima tie; all ties
    table_, deg_ = random_table(rng, 1000, dev)
    for F in (1, 32, 64, 75, 128):
        h = torch.from_numpy(rng.randn(1000, F).astype(np.float32)).to(dev)
        nei_cases.append(nei_sum_case(f'degrees_0_10_F{F}', h, table_,
                                      deg_))
    # K1 and K2 at F 4 (4 lanes a node) and at F 64 off 16-byte alignment
    for F, tag, place in ((4, '', lambda t: t),
                          (64, '_misaligned', misaligned)):
        h = place(torch.from_numpy(rng.randn(1000, F).astype(
            np.float32)).to(dev))
        nei_cases.append(nei_sum_case(f'degrees_0_10_F{F}{tag}', h, table_,
                                      deg_))
        max_cases.append(nei_max_cases(
            f'degrees_0_10_F{F}{tag}', h, table_, deg_,
            place(torch.randn((1000, F), generator=gen, device=dev))))
    for F in (1, 75):
        h = torch.from_numpy(np.maximum(rng.randint(-2, 3, (1000, F)), 0)
                             .astype(np.float32)).to(dev)
        max_cases.append(nei_max_cases(
            f'ties_degrees_0_10_F{F}', h, table_, deg_,
            torch.randn((1000, F), generator=gen, device=dev)))
    max_cases.append(nei_max_cases(
        'all_ties_F64', torch.zeros(1000, 64, device=dev), table_, deg_,
        torch.randn((1000, 64), generator=gen, device=dev)))
    _, win = nei_max_incl_self(torch.zeros(1000, 64, device=dev), table_,
                               deg_, return_winner=True)
    check(bool((win == torch.arange(1000, device=dev)[:, None]).all()),
          'K2: self wins an all-tie max')
    # graphs of 3, 5, 0, 1, 40, 0 and 17 rows, 2 empty slots, a ghost
    # tail of 20 rows; integer values (ties), one masked row
    sizes = [3, 5, 0, 1, 40, 0, 17]
    G = len(sizes) + 2
    pool_rp = torch.tensor(np.concatenate([[0], np.cumsum(
        sizes + [0, 0])]), dtype=torch.int32, device=dev)
    N = sum(sizes) + 20
    pool_mask = (torch.arange(N, device=dev) < sum(sizes)).float()
    pool_mask[4] = 0.0
    for F in (1, 37, 128):
        x = torch.from_numpy(rng.randint(-3, 3, (N, F)).astype(
            np.float32)).to(dev)
        pool_cases.append(graph_max_cases(
            f'empty_graphs_ties_F{F}', x, pool_rp, pool_mask,
            torch.randn((G, F), generator=gen, device=dev)))
    out = graph_max_pool(torch.full((N, 4), NEG, device=dev), pool_rp,
                         pool_mask)
    check(bool((out == 0).all()), 'K3: rows at NEG and empty graphs give 0')
    non_finite_cases(rng, dev)
    launched = (nei_sum.launches, nei_max_incl_self.backward_launches,
                nei_max_incl_self.launches, graph_max_pool.launches,
                graph_max_pool.backward_launches)
    for kname, total, before4, after4 in zip(
            ('K1', 'K2 backward', 'K2 forward', 'K3 forward', 'K3 backward'),
            (a - b for a, b in zip(launched, paths_before[0])),
            paths_before[1],
            float4_launches() + graph_max_pool_float4_launches()):
        float4 = after4 - before4
        print(f'phase 3 {kname} paths: {float4} float4 launches, '
              f'{total - float4} one float a lane', flush=True)
        check(0 < float4 < total,
              f'{kname} launched both kernel paths: {float4} float4, '
              f'{total - float4} one float a lane')
    # K1 in GCN's layers (F 30 and 64) and DMPNN's edge sums (F 300 from
    # 4096 edge rows), K4 in GAT's (C 8 and 64) and AttentiveFP's (C 200)
    # layers, at the inputs each model hands them in phase 13's and 14's
    # first batch of 100
    from deepchem_tpu_torch import (AttentiveFPModel, DMPNNFeaturizer,
                                    DMPNNModel, GATModel, GCNModel,
                                    MolGraphConvFeaturizer)
    from deepchem_tpu_torch.models import dmpnn as dmpnn_module
    gnn_X, gnn_y = table_data(MolGraphConvFeaturizer(), SMILES)
    dm_X, dm_y = table_data(DMPNNFeaturizer(), SMILES + STEREO_SMILES)
    gnn_makers = {
        'gcn': lambda d, seed, **kw: GCNModel(**GCN, device=d, seed=seed,
                                              **kw),
        'gat': lambda d, seed, **kw: GATModel(**GAT, device=d, seed=seed,
                                              **kw),
        'attentivefp': lambda d, seed, **kw: AttentiveFPModel(
            **ATTENTIVEFP, device=d, seed=seed, **kw)}

    def dm_make(d, seed, **kw):
        return DMPNNModel(**DMPNN, device=d, seed=seed, **kw)
    gnn_models = {k: make(dev, 0) for k, make in gnn_makers.items()}
    dm_model = dm_make(dev, 0)
    B = dm_model.batch_size
    gcn_sum_in = recorded(graph_layers, 'nei_sum', lambda: gnn_models[
        'gcn'].predict_on_batch(gnn_X[:B]))
    dm_sum_in = recorded(dmpnn_module, 'nei_sum_edges',
                         lambda: dm_model.predict_on_batch(dm_X[:B]))
    gather_in = {k: recorded(graph_layers, 'nei_gather', lambda: gnn_models[
        k].predict_on_batch(gnn_X[:B])) for k in ('gat', 'attentivefp')}
    check([a[0].shape[1] for a in gcn_sum_in] == [30, 64],
          'GCN: K1 at F 30 and 64')
    check([tuple(a[0].shape[1:]) for a in dm_sum_in] == [(300,)] * 3
          and dm_sum_in[0][0].shape[0] != dm_sum_in[0][1].shape[0],
          'DMPNN: K1 from [E, 300] edge rows into N nodes, 3 a forward')
    check([tuple(a[0].shape[1:]) for a in gather_in['gat']]
          == [(8,), (8, 8)] * 2
          and [tuple(a[0].shape[1:]) for a in gather_in['attentivefp']]
          == [(200,)] * 4, "K4 at GAT's C 8 and 8 x 8, AttentiveFP's C 200")
    new_k1_cases = [nei_sum_case(f'gcn_batch100_layer{i}', *a[:3])
                    for i, a in enumerate(gcn_sum_in)] + [
        nei_sum_case('dmpnn_batch100_nei_sum_edges', *dm_sum_in[0][:3])]
    gather_before = (nei_gather.launches, nei_gather_float4_launches())
    k4_cases = [
        nei_gather_cases(f'{k}_batch100_layer0_{part}', *a, torch.randn(
            tuple(a[1].shape) + tuple(a[0].shape[1:]), generator=gen,
            device=dev))
        for k, part, a in (('gat', 'e_src', gather_in['gat'][0]),
                           ('gat', 'z', gather_in['gat'][1]),
                           ('attentivefp', 'z', gather_in['attentivefp'][0]))]
    more_non_finite_cases(dev)
    total = nei_gather.launches - gather_before[0]
    float4 = nei_gather_float4_launches() - gather_before[1]
    print(f'phase 3 K4 paths: {float4} float4 launches, {total - float4} '
          f'one float a lane', flush=True)
    check(0 < float4 < total, f'K4 launched both kernel paths: {float4} '
          f'float4, {total - float4} one float a lane')
    # P2 (f32) and K3 on the COO models' paths, at the inputs phase 16's
    # first batch of 100 hands them: GNNModular's GCN layers (F 30 and 64,
    # forward, and the backward's transpose), PNA's edge sums (the [E, 64]
    # messages by destination) and its max over each node's edges (K3)
    from deepchem_tpu_torch import (GNNModular, InfoGraphStarModel,
                                    PNAModel)
    from deepchem_tpu_torch.ops import coo as coo_module
    coo_makers = {
        'pna': lambda d, seed, **kw: PNAModel(**PNA, device=d, seed=seed,
                                              **kw),
        'gnn_regression': lambda d, seed, **kw: GNNModular(
            **GNN_REGRESSION, device=d, seed=seed, **kw),
        'gnn_edge_pred': lambda d, seed, **kw: GNNModular(
            **GNN_EDGE_PRED, device=d, seed=seed, **kw),
        'infograph_star': lambda d, seed, **kw: InfoGraphStarModel(
            **INFOGRAPH_STAR, device=d, seed=seed, **kw)}
    gnn_probe = coo_makers['gnn_regression'](dev, 0)
    pna_probe = coo_makers['pna'](dev, 0)
    gcn_fwd_in = recorded(csr_segment, '_gather_sum_forward',
                          lambda: gnn_probe.predict_on_batch(gnn_X[:B]))
    gcn_train_in = recorded(
        csr_segment, '_gather_sum_forward', lambda: gnn_probe.fit_on_batch(
            gnn_X[:B], gnn_y[:B], np.ones_like(gnn_y[:B])))
    pna_sum_in = recorded(csr_segment, '_gather_sum_forward',
                          lambda: pna_probe.predict_on_batch(gnn_X[:B]))
    pna_max_in = recorded(coo_module, 'graph_max_pool',
                          lambda: pna_probe.predict_on_batch(gnn_X[:B]))
    del gnn_probe, pna_probe
    gcn_bwd_in = [a for a in gcn_train_in if a[3:] == ('backward_launches',)]
    check([a[0].shape[1] for a in gcn_fwd_in] == [30, 64, 64]
          and len(gcn_bwd_in) == 2,
          'GNNModular: P2 at F 30, 64, 64 a forward, 2 in the backward')
    check(len(pna_sum_in) == 6 and len(pna_max_in) == 6
          and pna_sum_in[0][0].shape[0] == pna_sum_in[0][1].shape[0]
          and pna_max_in[0][0].shape[1] == 64,
          'PNA: P2 over [E, 64] edge rows 2 a layer, K3 2 a layer')
    coo_cases = [gather_case(f'gnn_batch100_layer{i}', *a[:3])
                 for i, a in enumerate(gcn_fwd_in[:2])]
    coo_cases.append(gather_case('gnn_batch100_layer2_backward',
                                 *gcn_bwd_in[0][:3]))
    coo_cases.append(gather_case('pna_batch100_edge_sum', *pna_sum_in[0]))
    x, rp_, emask_sorted = pna_max_in[0]
    pna_pool_cases = graph_max_cases(
        'pna_batch100_edge_max', x, rp_, emask_sorted, torch.randn(
            rp_.shape[0] - 1, x.shape[1], generator=gen, device=dev))

    # P1, P2 (both ways) and K3 on the COO branches' paths, at the inputs
    # phase 17's first batches hand them: GraphConv's neighbour sum (F 75,
    # the ghost edges' long last segment), its neighbour max (K3 over the
    # edge rows by destination) and that max's source gather backward
    # (P2 over the edge rows by source) at batch 256; GAT's edge softmax
    # (P1, [E, 8]) and DMPNN's edge sums (P2, [E, 300]) at batch 100
    from deepchem_tpu_torch.ops import segment as seg_module
    gc_cls = type(gc_model)
    with coo_branch(gc_cls):
        gc_coo = gc_cls(**GRAPHCONV, device=dev, seed=0)
        gcb = gc_X[:GRAPHCONV['batch_size']]
        gc_p2_in = recorded(csr_segment, '_gather_sum_forward',
                            lambda: gc_coo.predict_on_batch(gcb))
        gc_k3_in = recorded(coo_module, 'graph_max_pool',
                            lambda: gc_coo.predict_on_batch(gcb))
        gc_train_in = recorded(
            csr_segment, '_gather_sum_forward', lambda: gc_coo.fit_on_batch(
                gcb, gc_labels[:len(gcb)], np.ones_like(gc_labels[:len(gcb)])))
    del gc_coo
    gat_cls = GATModel
    with coo_branch(gat_cls):
        gat_coo = gnn_makers['gat'](dev, 0)
        gat_p1_in = recorded(seg_module, 'csr_segment_softmax',
                             lambda: gat_coo.predict_on_batch(gnn_X[:B]))
    with coo_branch(DMPNNModel):
        dm_coo = dm_make(dev, 0)
        dm_p2_in = recorded(csr_segment, '_gather_sum_forward',
                            lambda: dm_coo.predict_on_batch(dm_X[:B]))
    del gat_coo, dm_coo
    # DMPNN COO in training: the epoch's caps leave ghost ranges far
    # longer than a served batch's (the backward's are the forward's)
    dm_fit_in = [a for a in dmpnn_coo_fit_p2_inputs(dev) if not a[3:]]
    ghosts = [int(a[2][-1] - a[2][-2]) for a in dm_fit_in]
    print(f'phase 3 DMPNN COO fit: P2 forward at '
          f'{sorted({tuple(a[0].shape) for a in dm_fit_in})}, ghost ranges '
          f'{min(ghosts)}-{max(ghosts)} rows', flush=True)
    check({a[0].shape[1] for a in dm_fit_in} == {300},
          "P2 at DMPNN's [E, 300] edge rows in training")
    dm_fit_longest = dm_fit_in[ghosts.index(max(ghosts))][:3]
    del dm_fit_in
    gc_bwd_in = [a for a in gc_train_in if a[3:] == ('backward_launches',)]
    check([a[0].shape[1] for a in gc_p2_in] == [75, 64]
          and len(gc_k3_in) == 2 and len(gc_bwd_in) == 3,
          'GraphConv COO: P2 at F 75 and 64, K3 2 neighbour maxima (and '
          'the readout), 3 P2 in the backward')
    check([tuple(a[0].shape[1:]) for a in gat_p1_in] == [(8,)] * 2
          and [a[0].shape[1] for a in dm_p2_in] == [300] * 3,
          "P1 at GAT's [E, 8] logits, P2 at DMPNN's [E, 300] edge rows")
    x, rp_, emask_sorted = gc_k3_in[0]
    coo_branch_cases = [
        gather_case('graphconv_coo_batch256_layer0', *gc_p2_in[0][:3]),
        gather_case('graphconv_coo_batch256_pool_max_backward',
                    *gc_bwd_in[-1][:3]),
        gather_case('dmpnn_coo_batch100_edge_sum', *dm_p2_in[0][:3]),
        gather_case('dmpnn_coo_fit_batch100_edge_sum', *dm_fit_longest),
        softmax_case('gat_coo_batch100_layer0', *gat_p1_in[0])]
    gc_pool_cases = graph_max_cases(
        'graphconv_coo_batch256_neighbour_max', x, rp_, emask_sorted,
        torch.randn(rp_.shape[0] - 1, x.shape[1], generator=gen,
                    device=dev))

    # P2 and P3 on DAG's path, at the inputs phase 19's first batch of 100
    # hands them: a level pass's sum of the selected messages into their
    # destinations ([E, 30] edge rows by the CSR by destination), the
    # backward of its source gather (P2 over the CSR by source) and the
    # sum readout of the roots (P3)
    from deepchem_tpu_torch import DAGModel
    dag_X, dag_y = dag_data()
    dag_probe = DAGModel(**DAG, device=dev, seed=0)
    dag_fwd_in = recorded(csr_segment, '_gather_sum_forward',
                          lambda: dag_probe.predict_on_batch(dag_X[:B]))
    dag_sum_in = recorded(csr_segment, '_segment_sum_forward',
                          lambda: dag_probe.predict_on_batch(dag_X[:B]))
    dag_train_in = recorded(
        csr_segment, '_gather_sum_forward', lambda: dag_probe.fit_on_batch(
            dag_X[:B], dag_y[:B], np.ones_like(dag_y[:B])))
    del dag_probe
    dag_bwd_in = [a for a in dag_train_in if a[3:] == ('backward_launches',)]
    check(len(dag_fwd_in) == DAG_LEVELS and len(dag_bwd_in) == DAG_LEVELS
          and {a[0].shape[1] for a in dag_fwd_in + dag_bwd_in} == {30}
          and len(dag_sum_in) == 1,
          'DAG: P2 at [E, 30] once a level pass, forward and backward; P3 '
          'once for the readout')
    dag_cases = [
        gather_case('dag_batch100_level_sum', *dag_fwd_in[0][:3]),
        gather_case('dag_batch100_source_gather_backward',
                    *dag_bwd_in[0][:3])]
    dag_sum_cases = [sum_case('dag_batch100_readout', *dag_sum_in[0])]

    # P2 and P3 on the materials models' path, at the inputs phase 20's
    # first batch of 32 crystals hands them: CGCNN's [E, 64] sum of edge
    # messages into their destinations (E = 12 N: every atom has 12
    # neighbours within 8 Å) and, in its backward, the gathers' transposes
    # (edge rows into their sources and destinations); MEGNet's sum of
    # its [E, 32] edge rows into their graphs (P3 over the nodes' sums by
    # graph); and the mean readouts on P3
    from deepchem_tpu_torch import CGCNNModel, MEGNetModel
    mat = materials_data()
    mat_y = mat['y']
    cg_probe = CGCNNModel(**CGCNN, device=dev, seed=0)
    cg_fwd_in = recorded(csr_segment, '_gather_sum_forward',
                         lambda: cg_probe.predict_on_batch(mat['cgcnn'][:32]))
    cg_sum_in = recorded(csr_segment, '_segment_sum_forward',
                         lambda: cg_probe.predict_on_batch(mat['cgcnn'][:32]))
    cg_train_in = recorded(
        csr_segment, '_gather_sum_forward', lambda: cg_probe.fit_on_batch(
            mat['cgcnn'][:32], mat_y[:32], np.ones_like(mat_y[:32])))
    del cg_probe
    cg_bwd_in = [a for a in cg_train_in if a[3:] == ('backward_launches',)]
    mg_probe = MEGNetModel(**MEGNET, device=dev, seed=0)
    mg_fwd_in = recorded(csr_segment, '_gather_sum_forward',
                         lambda: mg_probe.predict_on_batch(mat['cgcnn'][:32]))
    mg_sum_in = recorded(csr_segment, '_segment_sum_forward',
                         lambda: mg_probe.predict_on_batch(mat['cgcnn'][:32]))
    del mg_probe
    # InfoMax3D pretraining's first batch of 32 conformer graphs: the 3D
    # encoder's [E, 64] edge sum (P2) and the 2D encoder's max over each
    # atom's edges (K3)
    from deepchem_tpu_torch import InfoMax3DModular
    im_probe = InfoMax3DModular(task='pretrain', **INFOMAX3D, device=dev,
                                seed=0)

    def im_answer():
        im_probe.predict_on_generator(im_probe.default_generator(
            NumpyDataset(mat['conformer'][:32]), mode='predict'),
            output_types=['embedding'])
    im_sum_in = recorded(csr_segment, '_gather_sum_forward', im_answer)
    im_max_in = recorded(coo_module, 'graph_max_pool', im_answer)
    del im_probe
    check(len(im_sum_in) == 9 and len(im_max_in) == 6
          and im_max_in[0][0].shape[1] == 64,
          'InfoMax3D: P2 9 and K3 6 a pretraining batch')
    check(len(cg_fwd_in) == 3 and len(cg_bwd_in) == 6
          and {a[0].shape[1] for a in cg_fwd_in + cg_bwd_in} == {64}
          and [a[0].shape[1] for a in cg_sum_in] == [64, 1]
          and len(mg_fwd_in) == 1 and len(mg_sum_in) == 5
          and mg_sum_in[2][1].shape[0] == 32 + 2,
          'CGCNN: P2 at [E, 64] once a convolution, twice in its backward, '
          'P3 twice for the mean readout; MEGNet: P2 into the nodes, P3 '
          'five times (the edges into 33 graph segments the third)')
    mat_cases = [
        gather_case('cgcnn_batch32_edge_sum', *cg_fwd_in[0][:3]),
        gather_case('cgcnn_batch32_gather_backward', *cg_bwd_in[0][:3]),
        gather_case('infomax3d_batch32_net3d_edge_sum', *im_sum_in[-1][:3])]
    x, rp_, emask_sorted = im_max_in[0]
    im_pool_cases = graph_max_cases(
        'infomax3d_batch32_edge_max', x, rp_, emask_sorted, torch.randn(
            rp_.shape[0] - 1, x.shape[1], generator=gen, device=dev))
    mat_sum_cases = [sum_case('cgcnn_batch32_readout', *cg_sum_in[0]),
                     sum_case('megnet_batch32_state_pool', *mg_sum_in[0]),
                     sum_case('megnet_batch32_edges_into_graphs',
                              *mg_sum_in[2])]

    # -- 4. serve ---------------------------------------------------------
    phase_start(4)
    model.predict_on_batch(X[1:17])             # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    reset_launch_counts()
    outs, request_ms, n_batches, start = [], [], 0, 0
    for n in REQUESTS:
        t0 = time.perf_counter()
        outs.append(model.predict_on_batch(X[start:start + n]))
        request_ms.append((time.perf_counter() - t0) * 1e3)
        n_batches += -(-n // model.batch_size)
        start += n
    serve = launch_counts()
    print(f'phase 4 serve: requests {list(REQUESTS)} molecules, '
          f'{n_batches} batches, ms per request '
          f'{[round(t, 3) for t in request_ms]}, launches {serve}',
          flush=True)
    check(serve['csr_segment_softmax'] == n_layers * n_batches,
          f'P1: {serve["csr_segment_softmax"]} launches != {n_layers} '
          f'layers x {n_batches} batches')
    # P3 once a layer, and once for the sum readout (graph_pool)
    check(serve['csr_segment_sum'] == (n_layers + 1) * n_batches,
          f'P3: {serve["csr_segment_sum"]} launches != {n_layers + 1} x '
          f'{n_batches} batches')
    cpu_model = PagtnModel(n_tasks=12, mode='classification', device='cpu')
    cpu_model.module.load_state_dict(
        {k: v.cpu() for k, v in model.module.state_dict().items()})
    worst, start = 0.0, 0
    for n, out in zip(REQUESTS, outs):
        check(out.shape == (n, 12, 2), f'output shape {out.shape}')
        check(bool(np.isfinite(out).all()), 'finite outputs')
        check(np.allclose(out.sum(-1), 1.0, atol=1e-5), 'rows sum to 1')
        ref = cpu_model.predict_on_batch(X[start:start + n])
        worst = max(worst, float(np.abs(out - ref).max()))
        start += n
    print(f'phase 4 serve: outputs [n, 12, 2], finite, rows sum to 1; max '
          f'abs diff against the CPU run {worst:.3g}', flush=True)
    check(worst <= CPU_ATOL, f'card vs CPU {worst} > {CPU_ATOL}')

    # -- 5. train ---------------------------------------------------------
    phase_start(5)
    dataset = NumpyDataset(X, labels, weights)
    trainer = PagtnModel(n_tasks=12, mode='classification', device=dev,
                         seed=0, log_frequency=1)
    grads1, losses, marks = {}, [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(dataset, nb_epoch=4, all_losses=losses,
                callbacks=[step1_grads(grads1),
                           lambda m, step: marks.append(time.perf_counter())])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train = launch_counts()
    steps = trainer.get_global_step()
    step_ms = np.diff([t0] + marks) * 1e3
    print(f'phase 5 train: {steps} steps of {trainer.batch_size} molecules, '
          f'{train_s * 1e3 / steps:.3f} ms a step; host ms per step '
          f'{[round(float(t), 3) for t in step_ms]}; loss per step '
          f'{[round(v, 5) for v in losses]}; launches {train}', flush=True)
    check(steps == 12 and len(losses) == 12, '12 steps, 12 losses')
    check(bool(np.all(np.isfinite(losses))), 'finite losses')
    # a constant added to every logit of a segment leaves its softmax as
    # it is, so attn.bias has an exact gradient of 0: only rounding moves it
    shift = [n for n in grads1 if n.endswith('attn.bias')]
    zero = [n for n, g in grads1.items()
            if n not in shift and not g.abs().max() > 0]
    check(len(grads1) == len(list(trainer.module.parameters())) and not zero,
          f'every parameter gets a non-zero gradient on step 1; zero: {zero}')
    print(f'phase 5 train: step 1 gave {len(grads1)} non-zero gradients; '
          f'attn.bias, 0 by shift invariance, max |grad| '
          f'{max(grads1[n].abs().max().item() for n in shift):.3g}',
          flush=True)
    check(train['csr_segment_softmax'] == n_layers * steps,
          f'P1 launches {train["csr_segment_softmax"]} != {n_layers} a step')
    # P3 in each layer and P1's backward, and the sum readout's forward
    check(train['csr_segment_sum'] == (2 * n_layers + 1) * steps,
          f'P3 launches {train["csr_segment_sum"]} != {2 * n_layers + 1} a '
          f'step')

    # a dropout-free copy on the card and on the CPU, from the same weights
    copies, copy_losses, copy_grads = [], [], []
    for device in (dev, 'cpu'):
        m = PagtnModel(n_tasks=12, mode='classification', device=device,
                       seed=0, dropout=0.0, log_frequency=1)
        m.module.load_state_dict({k: v.to(device) for k, v in
                                  model.module.state_dict().items()})
        copy_losses.append([])
        copy_grads.append({})
        m.fit(dataset, nb_epoch=4, checkpoint_interval=0,
              all_losses=copy_losses[-1],
              callbacks=step1_grads(copy_grads[-1]))
        copies.append(m)
    grad_err = max((copy_grads[0][n] - g).abs().max().item()
                   for n, g in copy_grads[1].items())
    loss_rel = float(np.max(np.abs(np.subtract(*copy_losses))
                            / np.abs(copy_losses[1])))
    print(f'phase 5 train: dropout 0, card against CPU: step-1 gradients '
          f'max abs diff {grad_err:.3g}, 12-step losses max rel diff '
          f'{loss_rel:.3g}', flush=True)
    check(grad_err <= GRAD_ATOL, f'step-1 gradients {grad_err} > '
          f'{GRAD_ATOL}')
    check(loss_rel <= TRAIN_RTOL, f'loss trajectory {loss_rel} > '
          f'{TRAIN_RTOL}')

    # one fixed batch of 16 at the JAX overfit test's rate
    overfit = PagtnModel(n_tasks=12, mode='classification', device=dev,
                         seed=0, learning_rate=0.003, log_frequency=1)
    fixed = []
    overfit.fit(NumpyDataset(X[:16], labels[:16], weights[:16]),
                nb_epoch=50, checkpoint_interval=0, all_losses=fixed)
    below = next((i + 1 for i, v in enumerate(fixed) if v < 0.9 * fixed[0]),
                 None)
    print(f'phase 5 train: one fixed batch, lr 0.003: loss {fixed[0]:.5f} '
          f'at step 1, {min(fixed):.5f} at best, below 0.9 of the first '
          f'at step {below}', flush=True)
    check(below is not None, 'the loss falls below 0.9 of its first value '
          'within 50 steps')

    # -- 6. P4 flash attention against its plain versions ----------------
    phase_start(6)
    flash_cases = [flash_case(f'encoder_{kind}', FLASH_MAIN, dt, dev)
                   for kind, dt in (('bf16', torch.bfloat16),
                                    ('f32', torch.float32))]
    for dt in (torch.bfloat16, torch.float32):
        flash_cases.append(flash_case(
            f'unaligned_S200_D32_{str(dt)[6:]}', (3, 4, 200, 32), dt, dev))
    crossover = [(CROSSOVER_TOKENS // S, 12, S, 64) for S in CROSSOVER_S]
    for shape in crossover:
        flash_cases.append(flash_case(
            f'crossover_S{shape[2]}', shape, torch.bfloat16, dev,
            iters=CROSSOVER_ITERS if shape[2] <= 1024
            else CROSSOVER_ITERS // 4))
    # P4 in f32 (3xTF32 on the tensor cores) where it meets SDPA's
    for S in F32_CROSSOVER_S:
        flash_cases.append(flash_case(
            f'crossover_S{S}_f32', (CROSSOVER_TOKENS // S, 12, S, 64),
            torch.float32, dev, iters=CROSSOVER_ITERS if S <= 1024
            else CROSSOVER_ITERS // 4))
    # P4's own path: forward and backward once per crossover shape
    gen = torch.Generator(dev).manual_seed(1)
    torch.cuda.synchronize()
    reset_launch_counts()
    for shape in crossover:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16).requires_grad_(i < 3)
                       for i in range(4))
        out = flash_attention(q, k, v, shape[3] ** -0.5)
        out.backward(do)
        check(all(bool(torch.isfinite(t).all()) for t in
                  (out, q.grad, k.grad, v.grad)), 'P4 outputs finite')
    torch.cuda.synchronize()
    p4_path = launch_counts()
    del q, k, v, do, out
    print(f'phase 6 p4 path: forward and backward at {len(crossover)} '
          f'crossover shapes, launches {p4_path}', flush=True)
    for kname in ('flash_attention_fwd', 'flash_attention_dkv',
                  'flash_attention_dq'):
        check(p4_path[kname] == len(crossover),
              f'{kname} launched once per crossover shape')

    # -- 7. encoder serving, einsum route ---------------------------------
    phase_start(7)
    from deepchem_tpu_torch import BertEncoderMLM, SmilesTokenizer
    from deepchem_tpu_torch.models import AdamW, mlm_loss
    tok = SmilesTokenizer.from_corpus(SMILES)
    longest = max(len(tok.tokenize(s)) for s in SMILES) + 2
    check(tok.vocab_size <= ENCODER['vocab_size'] and longest <= SEQ,
          f'{tok.vocab_size} tokens, sequences of up to {longest}')
    ids, mask, mlm_in = mlm_batch(tok, SMILES, seed=0)
    n_enc_layers = ENCODER['layers']
    server = BertEncoderMLM(**ENCODER, device=dev, seed=0).eval()
    with torch.no_grad():
        server(ids[:16].to(dev), mask[:16].to(dev))    # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    served, request_ms, start = [], [], 0
    for n in REQUESTS:
        t0 = time.perf_counter()
        with torch.no_grad():
            served.append(server(ids[start:start + n].to(dev),
                                 mask[start:start + n].to(dev)).cpu())
        request_ms.append((time.perf_counter() - t0) * 1e3)
        start += n
    enc_serve = launch_counts()
    cpu_server = BertEncoderMLM(**ENCODER, device='cpu').eval()
    cpu_server.load_state_dict({k: v.cpu() for k, v in
                                server.state_dict().items()})
    worst, start = 0.0, 0
    for n, out in zip(REQUESTS, served):
        check(tuple(out.shape) == (n, SEQ, ENCODER['vocab_size'])
              and bool(torch.isfinite(out).all()),
              f'finite logits [{n}, {SEQ}, {ENCODER["vocab_size"]}]')
        with torch.no_grad():
            ref = cpu_server(ids[start:start + n], mask[start:start + n])
        worst = max(worst, scaled_err(out, ref))
        start += n
    del cpu_server
    print(f'phase 7 encoder serve: {tok.vocab_size} tokens in the '
          f'vocabulary, requests {list(REQUESTS)} SMILES padded to {SEQ}, '
          f'ms per request {[round(t, 3) for t in request_ms]}, logits '
          f'finite; max abs diff against the CPU run / max(1, |ref|) '
          f'{worst:.3g}; launches {enc_serve}', flush=True)
    check(worst <= CPU_ATOL, f'encoder card vs CPU {worst} > {CPU_ATOL}')
    check(enc_serve['flash_attention_fwd'] == 0,
          'the default (einsum) route launches no P4 kernel')

    # -- 8. the encoder through P4 ---------------------------------------
    phase_start(8)
    req = slice(REQUESTS[0] + REQUESTS[1], sum(REQUESTS))  # the 31 request
    with torch.no_grad():
        einsum_logits = server(ids[req].to(dev))
        torch.cuda.synchronize()
        reset_launch_counts()
        with flash_routed():
            flash_logits = server(ids[req].to(dev))
        torch.cuda.synchronize()
        serve_flash = launch_counts()
    del server
    serve_err = scaled_err(flash_logits, einsum_logits)
    print(f'phase 8 serve_flash: a request of {req.stop - req.start} SMILES, '
          f'no mask, float32: flash against einsum {serve_err:.3g}; '
          f'launches {serve_flash}', flush=True)
    check(serve_err <= ROUTE_TOL['float32'],
          f'flash route vs einsum {serve_err} > {ROUTE_TOL["float32"]}')
    check(serve_flash['flash_attention_fwd'] == n_enc_layers
          and serve_flash['flash_attention_dkv'] == 0,
          f'{n_enc_layers} P4 forward launches and no backward')

    b16 = slice(0, ENCODER_BATCH)
    batch = [t[b16].to(dev) for t in (mlm_in, ids, mask)]
    for kind, dt in (('float32', torch.float32),
                     ('bfloat16', torch.bfloat16)):
        model = BertEncoderMLM(**ENCODER, dtype=dt, device=dev,
                               seed=1).train()
        logits_e, loss_e, grads_e = encoder_step(model, *batch)
        with flash_routed():
            logits_f, loss_f, grads_f = encoder_step(model, *batch)
        logit_err = scaled_err(logits_f, logits_e)
        grad_err = max(scaled_err(grads_f[n], g) for n, g in grads_e.items())
        print(f'phase 8 step: {kind}, flash against einsum: logits '
              f'{logit_err:.3g}, step-1 gradients {grad_err:.3g} (of '
              f'max(1, |g|)); loss {loss_f.item():.5f} against '
              f'{loss_e.item():.5f}', flush=True)
        check(logit_err <= ROUTE_TOL[kind] and grad_err <= ROUTE_TOL[kind],
              f'{kind} flash route vs einsum: {logit_err}, {grad_err}')
        del model, grads_e, grads_f

    # 10 AdamW steps at batch 16 through P4, in bfloat16 and in float32
    batches = [[t[i:i + ENCODER_BATCH].to(dev) for t in (mlm_in, ids, mask)]
               for i in range(0, len(SMILES), ENCODER_BATCH)]
    train_paths = {}
    for kind, dt in (('bfloat16', torch.bfloat16),
                     ('float32', torch.float32)):
        trainer = BertEncoderMLM(**ENCODER, dtype=dt, device=dev,
                                 seed=2).train()
        opt = AdamW(learning_rate=ENCODER_LR)._create_torch_optimizer(
            trainer.parameters())
        enc_losses, per_step = [], []
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with flash_routed():
            for i in range(10):
                inputs, labels, label_mask = batches[i % len(batches)]
                opt.zero_grad(set_to_none=True)
                loss = mlm_loss(trainer(inputs), labels, label_mask)
                loss.backward()
                opt.step()
                enc_losses.append(loss.detach())
                per_step.append(launch_counts())
        torch.cuda.synchronize()
        enc_step_ms = (time.perf_counter() - t0) * 1e3 / 10
        train_paths[kind] = launch_counts()
        enc_losses = [v.item() for v in enc_losses]
        print(f'phase 8 train_flash: 10 AdamW steps of {ENCODER_BATCH} at '
              f'lr {ENCODER_LR}, {kind}, {enc_step_ms:.3f} ms a step; loss '
              f'per step {[round(v, 5) for v in enc_losses]}; launches '
              f'{train_paths[kind]}', flush=True)
        check(all(np.isfinite(enc_losses)), f'{kind}: finite losses')
        for i, counts in enumerate(per_step):
            for kname in ('flash_attention_fwd', 'flash_attention_dkv',
                          'flash_attention_dq'):
                check(counts[kname] == n_enc_layers * (i + 1),
                      f'{kind} {kname}: {n_enc_layers} launches a step')
        del trainer, opt
    train_flash, train_flash_f32 = (train_paths['bfloat16'],
                                    train_paths['float32'])

    overfit = BertEncoderMLM(**ENCODER, dtype=torch.bfloat16, device=dev,
                             seed=3).train()
    opt = AdamW(learning_rate=ENCODER_LR)._create_torch_optimizer(
        overfit.parameters())
    fixed, below = [], None
    with flash_routed():
        for step in range(1, 51):
            opt.zero_grad(set_to_none=True)
            loss = mlm_loss(overfit(batches[0][0]), *batches[0][1:])
            loss.backward()
            opt.step()
            fixed.append(loss.item())
            if fixed[-1] < 0.9 * fixed[0]:
                below = step
                break
    del overfit, opt
    print(f'phase 8 overfit: one fixed batch, lr {ENCODER_LR}: loss '
          f'{fixed[0]:.5f} at step 1, {fixed[-1]:.5f} at step '
          f'{len(fixed)}, below 0.9 of the first at step {below}',
          flush=True)
    check(below is not None, 'the loss falls below 0.9 of its first value '
          'within 50 steps')

    # -- 9. encoder gradients, card against CPU (einsum route, f32) -------
    phase_start(9)
    small = [t[:4] for t in (mlm_in, ids, mask)]
    models = [BertEncoderMLM(**ENCODER, device=d, seed=4).train()
              for d in (dev, 'cpu')]
    steps = [encoder_step(m, *[t.to(m.head_bias.device) for t in small],
                          mask=small[2].to(m.head_bias.device))
             for m in models]
    grad_err = max(scaled_err(steps[0][2][n].cpu(), g)
                   for n, g in steps[1][2].items())
    zero = [n for n, g in steps[0][2].items() if not g.abs().max() > 0]
    print(f'phase 9 encoder gradients: batch 4 with a mask, float32, card '
          f'against CPU: loss {steps[0][1].item():.6f} against '
          f'{steps[1][1].item():.6f}, step-1 gradients max abs diff / '
          f'max(1, |g|) {grad_err:.3g} over {len(steps[1][2])} parameters',
          flush=True)
    check(not zero, f'every parameter gets a gradient; zero: {zero}')
    check(grad_err <= CPU_ATOL, f'encoder gradients {grad_err} > '
          f'{CPU_ATOL}')
    del models, steps

    # -- 11. GraphConvModel, bench.py's main path ------------------------
    phase_start(11)
    gc_ds = NumpyDataset(gc_X, gc_labels, np.ones_like(gc_labels))
    B = GRAPHCONV['batch_size']
    # per batch of the forward: K1 and K2 once a layer, K3 and P3 once
    per_batch = {'nei_sum': n_gc_layers, 'nei_max_fwd': n_gc_layers,
                 'graph_max_pool_fwd': 1, 'csr_segment_sum': 1}
    gc_model.predict_on_batch(gc_X[:16])                 # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    outs, request_ms, start = [], [], 0
    for n in REQUESTS:
        t0 = time.perf_counter()
        outs.append(gc_model.predict_on_batch(gc_X[start:start + n]))
        request_ms.append((time.perf_counter() - t0) * 1e3)
        start += n
    gc_serve = launch_counts()
    cpu_gc = GraphConvModel(**GRAPHCONV, device='cpu')
    cpu_gc.module.load_state_dict(
        {k: v.cpu() for k, v in gc_model.module.state_dict().items()})
    worst, start = 0.0, 0
    for n, out in zip(REQUESTS, outs):
        check(out.shape == (n, 12, 2) and bool(np.isfinite(out).all())
              and np.allclose(out.sum(-1), 1.0, atol=1e-5),
              f'GraphConv output [{n}, 12, 2], finite, rows sum to 1')
        ref = cpu_gc.predict_on_batch(gc_X[start:start + n])
        worst = max(worst, float(np.abs(out - ref).max()))
        start += n
    print(f'phase 11 graphconv serve ({smi}): requests {list(REQUESTS)} '
          f'molecules, ms per request {[round(t, 3) for t in request_ms]}; '
          f'max abs diff against the CPU run {worst:.3g}; launches '
          f'{gc_serve}', flush=True)
    check(worst <= CPU_ATOL, f'GraphConv card vs CPU {worst} > {CPU_ATOL}')
    for k, v in launch_counts().items():
        want = per_batch.get(k, 0) * len(REQUESTS)
        check(gc_serve[k] == want, f'GraphConv serve: {k} launched '
              f'{gc_serve[k]} times, not {want}')
    t0 = time.perf_counter()
    every = gc_model.predict_on_device(gc_ds)
    on_device_ms = (time.perf_counter() - t0) * 1e3
    by_batch = gc_model.predict(gc_ds)
    on_device_err = float(np.abs(every - by_batch).max())
    check(every.shape == (GRAPHCONV_MOLECULES, 12, 2)
          and bool(np.isfinite(every).all()) and on_device_err <= CPU_ATOL,
          f'predict_on_device over {GRAPHCONV_MOLECULES}: finite, within '
          f'{CPU_ATOL} of predict ({on_device_err})')
    latency = []
    for i in range(LATENCY_REQUESTS):
        lo = (16 * i) % (GRAPHCONV_MOLECULES - 16)
        t0 = time.perf_counter()
        gc_model.predict_on_batch(gc_X[lo:lo + 16])
        latency.append((time.perf_counter() - t0) * 1e3)
    p50, p90 = np.percentile(latency, [50, 90])
    print(f'phase 11 graphconv serve ({smi}): predict_on_device over '
          f'{GRAPHCONV_MOLECULES} molecules in {on_device_ms:.3f} ms, within '
          f'{on_device_err:.3g} of predict; {LATENCY_REQUESTS} requests of '
          f'16 molecules: median {p50:.3f} ms, p90 {p90:.3f} ms', flush=True)

    # training: fit_on_device, 3 epochs of 3 steps of 256
    trainer = GraphConvModel(**GRAPHCONV, device=dev, seed=1)
    torch.cuda.synchronize()
    reset_launch_counts()
    epoch_losses = []
    trainer.fit_on_device(gc_ds, nb_epoch=1, seed=0,
                          all_losses=epoch_losses)   # uploads, warms up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit_on_device(gc_ds, nb_epoch=2, seed=1,
                          all_losses=epoch_losses)
    torch.cuda.synchronize()
    S = -(-GRAPHCONV_MOLECULES // B)
    gc_step_ms = (time.perf_counter() - t0) * 1e3 / (2 * S)
    gc_train = launch_counts()
    gc_steps = trainer.get_global_step()
    print(f'phase 11 graphconv train ({smi}): fit_on_device, {gc_steps} '
          f'steps of {B} molecules, {gc_step_ms:.3f} ms a step over the '
          f'last 2 epochs; loss per epoch '
          f'{[round(v, 5) for v in epoch_losses]}; launches {gc_train}',
          flush=True)
    check(gc_steps == 3 * S and len(epoch_losses) == 3
          and bool(np.all(np.isfinite(epoch_losses))),
          f'{3 * S} steps, 3 finite epoch losses')
    # a step: the forward's launches, K1's backward once (layer 1's input
    # needs no gradient), K2's twice, K3's once; P3's backward is a gather
    per_step = dict(per_batch, nei_sum_bwd=1, nei_max_bwd=n_gc_layers,
                    graph_max_pool_bwd=1)
    for k in gc_train:
        want = per_step.get(k, 0) * gc_steps
        check(gc_train[k] == want, f'GraphConv train: {k} launched '
              f'{gc_train[k]} times, not {want}')

    # step-1 gradients, card against CPU, from the same weights
    grads = []
    for device in (dev, 'cpu'):
        m = GraphConvModel(**GRAPHCONV, device=device, log_frequency=1)
        m.module.load_state_dict({k: v.to(device) for k, v in
                                  gc_model.module.state_dict().items()})
        grads.append({})
        m.fit(NumpyDataset(gc_X[:B], gc_labels[:B]), nb_epoch=1,
              checkpoint_interval=0, callbacks=step1_grads(grads[-1]))
    gc_grad_err = max((grads[0][n] - g).abs().max().item()
                      for n, g in grads[1].items())
    zero = [n for n, g in grads[0].items() if not g.abs().max() > 0]
    print(f'phase 11 graphconv train: step-1 gradients, card against CPU, '
          f'max abs diff {gc_grad_err:.3g} over {len(grads[1])} parameters; '
          f'zero gradients: {zero}', flush=True)
    check(gc_grad_err <= GRAD_ATOL, f'GraphConv step-1 gradients '
          f'{gc_grad_err} > {GRAD_ATOL}')
    del grads
    # one fixed batch of 256 at bench.py's rate
    overfit = GraphConvModel(**GRAPHCONV, device=dev, seed=2)
    fixed = []
    overfit.fit_on_device(NumpyDataset(gc_X[:B], gc_labels[:B]),
                          nb_epoch=50, all_losses=fixed)
    below = next((i + 1 for i, v in enumerate(fixed) if v < 0.9 * fixed[0]),
                 None)
    print(f'phase 11 graphconv train: one fixed batch of {B}, lr '
          f'{GRAPHCONV["learning_rate"]}: loss {fixed[0]:.5f} at step 1, '
          f'{min(fixed):.5f} at best, below 0.9 of the first at step '
          f'{below}', flush=True)
    check(below is not None, 'the loss falls below 0.9 of its first value '
          'within 50 steps')
    del overfit

    # scoring: ROC-AUC over the 768, card against CPU
    from deepchem_tpu_torch import Metric, roc_auc_score
    metric = Metric(roc_auc_score, np.mean)
    cpu_gc.module.load_state_dict(
        {k: v.cpu() for k, v in trainer.module.state_dict().items()})
    t0 = time.perf_counter()
    auc = trainer.evaluate(gc_ds, [metric])['roc_auc_score']
    eval_ms = (time.perf_counter() - t0) * 1e3
    cpu_auc = cpu_gc.evaluate(gc_ds, [metric])['roc_auc_score']
    print(f'phase 11 graphconv evaluate ({smi}): ROC-AUC {auc:.6f} on the '
          f'card in {eval_ms:.3f} ms, {cpu_auc:.6f} on the CPU', flush=True)
    check(bool(np.isfinite(auc)) and abs(auc - cpu_auc) <= ROC_ATOL,
          f'ROC-AUC {auc} finite and within {ROC_ATOL} of the CPU\'s '
          f'{cpu_auc}')
    del cpu_gc, trainer

    # -- 12. MPNNModel at the JAX package's defaults ---------------------
    phase_start(12)
    from deepchem_tpu_torch import (MPNNModel, NormalizationTransformer,
                                    mae_score, pearson_r2_score, rms_score)
    raw_ds = NumpyDataset(mp_X, mp_y)
    mp_t = NormalizationTransformer(transform_y=True, dataset=raw_ds)
    mp_ds = mp_t.transform(raw_ds)
    B = mp_model.batch_size
    # per batch of the forward: K1 once a message step, P1 and P3 once a
    # set2set step
    per_batch = {'nei_sum_edges': T, 'csr_segment_softmax': M,
                 'csr_segment_sum': M}
    mp_model.predict_on_batch(mp_X[:16])                 # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    outs, request_ms, start = [], [], 0
    for n in REQUESTS:
        t0 = time.perf_counter()
        outs.append(mp_model.predict_on_batch(mp_X[start:start + n]))
        request_ms.append((time.perf_counter() - t0) * 1e3)
        start += n
    mp_serve = launch_counts()
    cpu_mp = MPNNModel(**MPNN, device='cpu')
    cpu_mp.module.load_state_dict(
        {k: v.cpu() for k, v in mp_model.module.state_dict().items()})
    worst, start = 0.0, 0
    for n, out in zip(REQUESTS, outs):
        check(out.shape == (n, 1) and bool(np.isfinite(out).all()),
              f'MPNN output [{n}, 1], finite')
        ref = cpu_mp.predict_on_batch(mp_X[start:start + n])
        worst = max(worst, float(np.abs(out - ref).max()))
        start += n
    print(f'phase 12 mpnn serve ({smi}): requests {list(REQUESTS)} '
          f'molecules, ms per request {[round(t, 3) for t in request_ms]}; '
          f'max abs diff against the CPU run {worst:.3g}; launches '
          f'{mp_serve}', flush=True)
    check(worst <= CPU_ATOL, f'MPNN card vs CPU {worst} > {CPU_ATOL}')
    for k, v in mp_serve.items():
        want = per_batch.get(k, 0) * len(REQUESTS)
        check(v == want, f'MPNN serve: {k} launched {v} times, not {want}')
    t0 = time.perf_counter()
    every = mp_model.predict(mp_ds, [mp_t])
    predict_ms = (time.perf_counter() - t0) * 1e3
    predict_err = float(np.abs(every - cpu_mp.predict(mp_ds, [mp_t])).max())
    check(every.shape == (MPNN_MOLECULES, 1)
          and bool(np.isfinite(every).all()) and predict_err <= CPU_ATOL,
          f'predict over {MPNN_MOLECULES}: finite, within {CPU_ATOL} of the '
          f'CPU ({predict_err})')
    latency = []
    for i in range(LATENCY_REQUESTS):
        lo = (16 * i) % (MPNN_MOLECULES - 16)
        t0 = time.perf_counter()
        mp_model.predict_on_batch(mp_X[lo:lo + 16])
        latency.append((time.perf_counter() - t0) * 1e3)
    p50, p90 = np.percentile(latency, [50, 90])
    print(f'phase 12 mpnn serve ({smi}): predict over {MPNN_MOLECULES} '
          f'molecules, in the labels\' units, in {predict_ms:.3f} ms, within '
          f'{predict_err:.3g} of the CPU; {LATENCY_REQUESTS} requests of 16 '
          f'molecules: median {p50:.3f} ms, p90 {p90:.3f} ms', flush=True)

    # training: fit, 3 epochs of 3 steps of 100
    S = -(-MPNN_MOLECULES // B)
    trainer = MPNNModel(**MPNN, device=dev, seed=1, log_frequency=S)
    torch.cuda.synchronize()
    reset_launch_counts()
    epoch_losses = []
    trainer.fit(mp_ds, nb_epoch=1, checkpoint_interval=0,
                all_losses=epoch_losses)          # packs, warms up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(mp_ds, nb_epoch=2, checkpoint_interval=0,
                all_losses=epoch_losses)
    torch.cuda.synchronize()
    mp_step_ms = (time.perf_counter() - t0) * 1e3 / (2 * S)
    mp_train = launch_counts()
    mp_steps = trainer.get_global_step()
    print(f'phase 12 mpnn train ({smi}): fit, {mp_steps} steps of {B} '
          f'molecules, {mp_step_ms:.3f} ms a step over the last 2 epochs; '
          f'loss per epoch {[round(v, 5) for v in epoch_losses]}; launches '
          f'{mp_train}', flush=True)
    check(mp_steps == 3 * S and len(epoch_losses) == 3
          and bool(np.all(np.isfinite(epoch_losses))),
          f'{3 * S} steps, 3 finite epoch losses')
    # a step: the forward's launches, K1 again in each take_src's
    # backward, P3 again in each P1's backward (P3's own is a gather) and
    # in each set2set round's gather of the graphs' queries for their
    # nodes (gather_graph_rows: index_add_'s float atomics made the step
    # differ run to run)
    per_step = dict(per_batch, take_src_bwd=T, csr_segment_sum=3 * M)
    for k, v in mp_train.items():
        want = per_step.get(k, 0) * mp_steps
        check(v == want, f'MPNN train: {k} launched {v} times, not {want}')

    # step-1 gradients, card against CPU, from the same weights
    grads = []
    for device in (dev, 'cpu'):
        m = MPNNModel(**MPNN, device=device, log_frequency=1)
        m.module.load_state_dict({k: v.to(device) for k, v in
                                  mp_model.module.state_dict().items()})
        grads.append({})
        m.fit(NumpyDataset(mp_X[:B], mp_ds.y[:B]), nb_epoch=1,
              checkpoint_interval=0, callbacks=step1_grads(grads[-1]))
    mp_grad_err = max(scaled_err(grads[0][n], g)
                      for n, g in grads[1].items())
    zero = [n for n, g in grads[0].items() if not g.abs().max() > 0]
    print(f'phase 12 mpnn train: step-1 gradients, card against CPU, max '
          f'abs diff over max(1, |g|) {mp_grad_err:.3g} over '
          f'{len(grads[1])} parameters; zero gradients: {zero}', flush=True)
    check(mp_grad_err <= GRAD_ATOL, f'MPNN step-1 gradients {mp_grad_err} '
          f'> {GRAD_ATOL} of max(1, |g|)')
    check(not zero, f'every parameter gets a gradient; zero: {zero}')
    del grads
    differ, n_params = fit_bits(
        lambda d, seed, **kw: MPNNModel(**MPNN, device=d, seed=seed, **kw),
        mp_X, mp_ds.y, dev)
    print(f'phase 12 mpnn train: two fits of 2 steps from seed 0 on the '
          f'card, every gradient and weight of {n_params} parameters the '
          f'same bits: {not differ}; differing: {differ}', flush=True)
    check(not differ, f'MPNN: two fits from one seed differ in {differ}')
    overfit = MPNNModel(**MPNN, device=dev, seed=2, log_frequency=1)
    fixed = []
    overfit.fit(NumpyDataset(mp_X[:B], mp_ds.y[:B]), nb_epoch=50,
                checkpoint_interval=0, all_losses=fixed)
    below = next((i + 1 for i, v in enumerate(fixed) if v < 0.9 * fixed[0]),
                 None)
    print(f'phase 12 mpnn train: one fixed batch of {B}, lr 0.001: loss '
          f'{fixed[0]:.5f} at step 1, {min(fixed):.5f} at best, below 0.9 '
          f'of the first at step {below}', flush=True)
    check(below is not None, 'the loss falls below 0.9 of its first value '
          'within 50 steps')
    del overfit

    # scoring: through the transformer, in the labels' units
    metrics = [Metric(pearson_r2_score), Metric(rms_score),
               Metric(mae_score)]
    cpu_mp.module.load_state_dict(
        {k: v.cpu() for k, v in trainer.module.state_dict().items()})
    t0 = time.perf_counter()
    scores = trainer.evaluate(mp_ds, metrics, [mp_t])
    eval_ms = (time.perf_counter() - t0) * 1e3
    cpu_scores = cpu_mp.evaluate(mp_ds, metrics, [mp_t])
    eval_err = max(abs(scores[k] - cpu_scores[k]) for k in cpu_scores)
    print(f'phase 12 mpnn evaluate ({smi}): {json.dumps(scores)} on the card '
          f'in {eval_ms:.3f} ms, {json.dumps(cpu_scores)} on the CPU',
          flush=True)
    check(set(scores) == set(cpu_scores) and eval_err <= EVAL_ATOL
          and all(np.isfinite(v) for v in scores.values()),
          f'evaluate finite and within {EVAL_ATOL} of the CPU ({eval_err})')
    del cpu_mp, trainer

    # -- 13. GCN, GAT and AttentiveFP at the JAX package's defaults ------
    phase_start(13)
    # per batch of the forward: GCN K1 once a layer, GAT and AttentiveFP K4
    # twice a layer; P3 once for the sum readout, twice for the mean (the
    # node counts); a step adds K1 in K4's backward, and GCN's K1 backward
    # in its second layer (the first reads the atoms, which need none)
    table_runs = {}
    for k, per_batch in (('gcn', {'nei_sum': 2, 'csr_segment_sum': 2}),
                         ('gat', {'nei_gather': 4, 'csr_segment_sum': 2}),
                         ('attentivefp', {'nei_gather': 4,
                                          'csr_segment_sum': 1})):
        per_step = dict(per_batch, **({'nei_sum_bwd': 1} if k == 'gcn'
                                      else {'nei_gather_bwd': 4}))
        table_runs[k] = model_phase(13, k, gnn_makers[k], gnn_X, gnn_y,
                                    per_batch, per_step, smi)
    del gnn_models

    # -- 14. DMPNN at the JAX package's defaults --------------------------
    phase_start(14)
    # K1 once a round and once after, P3 once; nei_sum_edges' backward is
    # a gather; a step adds K1 in the backward of each round's gather of
    # the node sums by source (take_src over the outgoing table e_table ^
    # 1: index_select's index_add_ differed run to run)
    per_batch = {'nei_sum_edges': 3, 'csr_segment_sum': 1}
    table_runs['dmpnn'] = model_phase(14, 'dmpnn', dm_make, dm_X, dm_y,
                                      per_batch,
                                      dict(per_batch, take_src_bwd=2), smi,
                                      same_bits=True)
    del dm_model

    # -- 15. the engine on GraphConv at bench.py's width ------------------
    phase_start(15)
    engine = engine_phase(dev, smi)

    # -- 16. the COO message-passing models at the JAX package's defaults -
    phase_start(16)
    # per batch of the forward: P2 once a GCN layer (GNNModular, InfoGraph*)
    # or twice a PNA layer (the mean and the variance's sums), K3 twice a
    # PNA layer (max, min); P3 twice for a mean readout (PNA, GNNModular's
    # regressor), once for InfoGraph*'s sum; a step adds P2's transpose in
    # the GCN layers after the first (which reads the atoms) and K3's
    # backward; also P2 in the backward of each gather of node
    # rows by an edge's end (PNA 3 a layer: h by source and destination,
    # the mean by destination; edge prediction 2: h by source and by
    # destination), where index_select's index_add_ differed run to run
    gcn = {'fused_gather_segment_sum': 3}
    coo_runs = {}
    for k, per_batch, per_step, scored in (
            ('pna', {'fused_gather_segment_sum': 6, 'graph_max_pool_fwd': 6,
                     'csr_segment_sum': 2},
             {'graph_max_pool_bwd': 6, 'fused_gather_segment_sum_bwd': 9},
             True),
            ('gnn_regression', dict(gcn, csr_segment_sum=2),
             {'fused_gather_segment_sum_bwd': 2}, True),
            ('gnn_edge_pred', gcn, {'fused_gather_segment_sum_bwd': 4},
             False),
            ('infograph_star', dict(gcn, csr_segment_sum=1),
             {'fused_gather_segment_sum_bwd': 2}, True)):
        coo_runs[k] = model_phase(16, k, coo_makers[k], gnn_X, gnn_y,
                                  per_batch, dict(per_batch, **per_step),
                                  smi, scored,
                                  same_bits=k in ('pna', 'gnn_edge_pred'))

    # -- 17. the COO branches -------------------------------------------
    phase_start(17)
    # per batch of the forward: P2 once a GraphConv or GCN layer, once a
    # GAT or AttentiveFP layer (the weighted messages) after P1 (the edge
    # softmax), once a DMPNN round and after (the edge states' sums), once
    # an MPNN step; K3 once a GraphConv layer (the neighbour max) and for
    # the max readout; P1 M times and P3 M times in MPNN's set2set, P3 for
    # the readouts.  A step adds P2's transpose for each source or
    # destination gather and GraphConv's and GCN's neighbour sums after
    # the first layer, K3's backward, and P3 in each P1's backward
    from deepchem_tpu_torch import MPNNModel as MPNNCls
    branch_runs, branch_diffs = {}, {}
    n_gc = len(GRAPHCONV['graph_conv_layers'])
    for k, cls, make, X_k, y_k, per_batch, per_step, extra in (
            ('graphconv', gc_cls,
             lambda d, seed, **kw: gc_cls(**GRAPHCONV, device=d, seed=seed,
                                          **kw),
             gc_X, gc_labels,
             {'fused_gather_segment_sum': n_gc,
              'graph_max_pool_fwd': n_gc + 1, 'csr_segment_sum': 1},
             {'fused_gather_segment_sum_bwd': 2 * n_gc - 1,
              'graph_max_pool_bwd': n_gc + 1},
             dict(out_tail=(GRAPHCONV['n_tasks'], 2), metrics=[
                 Metric(roc_auc_score, np.mean)])),
            ('gcn', GCNModel, gnn_makers['gcn'], gnn_X, gnn_y,
             {'fused_gather_segment_sum': 2, 'csr_segment_sum': 2},
             {'fused_gather_segment_sum_bwd': 1}, {}),
            ('gat', GATModel, gnn_makers['gat'], gnn_X, gnn_y,
             {'csr_segment_softmax': 2, 'fused_gather_segment_sum': 2,
              'csr_segment_sum': 2},
             {'fused_gather_segment_sum_bwd': 6, 'csr_segment_sum': 4}, {}),
            ('attentivefp', AttentiveFPModel, gnn_makers['attentivefp'],
             gnn_X, gnn_y,
             {'csr_segment_softmax': 2, 'fused_gather_segment_sum': 2,
              'csr_segment_sum': 1},
             {'fused_gather_segment_sum_bwd': 6, 'csr_segment_sum': 3}, {}),
            ('mpnn', MPNNCls,
             lambda d, seed, **kw: MPNNCls(**MPNN, device=d, seed=seed,
                                           **kw), mp_X, mp_y,
             {'fused_gather_segment_sum': 3, 'csr_segment_softmax': 6,
              'csr_segment_sum': 6},
             {'fused_gather_segment_sum_bwd': 3, 'csr_segment_sum': 18},
             {'same_bits': True}),
            ('dmpnn', DMPNNModel, dm_make, dm_X, dm_y,
             {'fused_gather_segment_sum': 3, 'csr_segment_sum': 1},
             {'fused_gather_segment_sum_bwd': 2}, {})):
        t0 = time.perf_counter()
        branch_diffs[k] = table_vs_coo(k, cls, make, X_k)
        with coo_branch(cls):
            branch_runs[f'{k}_coo'] = model_phase(
                17, f'{k}_coo', make, X_k, y_k, per_batch,
                dict(per_batch, **per_step), smi, **extra)
        print(f'phase 17 {k}: {time.perf_counter() - t0:.1f} s', flush=True)

    # -- 18. the fingerprint models --------------------------------------
    phase_start(18)
    from deepchem_tpu_torch.models import (MultitaskClassifier,
                                           MultitaskIRVClassifier,
                                           MultitaskRegressor,
                                           ProgressiveMultitaskClassifier,
                                           RobustMultitaskClassifier,
                                           ScScoreModel,
                                           SingletaskToMultitask)
    from deepchem_tpu_torch.trans import IRVTransformer
    fp_X, fp_labels, fp_values, fp_ms, first = dense_data()
    fp_cls = NumpyDataset(fp_X, fp_labels)
    fp_reg = NumpyDataset(fp_X, fp_values)

    def scored_rows(data):
        return NumpyDataset(data.X[first], data.y[first])

    def auc(m, data=fp_cls):
        return m.evaluate(scored_rows(data),
                          [Metric(roc_auc_score, np.mean)])

    def rms(m, data=fp_reg):
        return m.evaluate(scored_rows(data), [Metric(rms_score, np.mean)])
    irv_ds = IRVTransformer(IRV_K, DENSE_TASKS, fp_cls).transform(fp_cls)
    pairs = NumpyDataset(np.stack([fp_X, np.roll(fp_X, 1, axis=0)], axis=1),
                         np.zeros((DENSE_MOLECULES, 1), np.float32))
    pairs_scored = NumpyDataset(np.stack(
        [fp_X[first], np.roll(fp_X[first], 1, axis=0)], axis=1))

    def sc_score(m):
        s1, s2 = m.predict(pairs_scored)
        return {'mean_score': float(np.mean(s2)), 'hinge_loss': float(
            np.mean(np.maximum(1.0 - (s2 - s1), 0.0)))}
    single = NumpyDataset(fp_X, fp_values[:, :SINGLETASK_TASKS])

    def single_rms(m):
        pred = m.predict(scored_rows(single))
        return {'rms_score': float(np.sqrt(np.mean(
            (pred - single.y[first]) ** 2)))}
    dense_runs = {}
    for k, make, data, score in (
            ('tf', lambda d: MultitaskClassifier(**TF, device=d), fp_cls,
             auc),
            ('tf_robust', lambda d: RobustMultitaskClassifier(
                **TF_ROBUST, device=d), fp_cls, auc),
            ('tf_regression', lambda d: MultitaskRegressor(
                **TF_REGRESSION, device=d), fp_reg, rms),
            ('progressive', lambda d: ProgressiveMultitaskClassifier(
                **PROGRESSIVE, device=d), fp_cls, auc),
            ('irv', lambda d: MultitaskIRVClassifier(
                DENSE_TASKS, K=IRV_K, device=d), irv_ds,
             lambda m: auc(m, irv_ds)),
            ('scscore', lambda d: ScScoreModel(**SCSCORE, device=d), pairs,
             sc_score),
            ('singletask_to_multitask', lambda d: SingletaskToMultitask(
                list(range(SINGLETASK_TASKS)), lambda t: MultitaskRegressor(
                    1, FP_BITS, device=d)), single, single_rms)):
        dense_runs[k] = dense_phase(k, make, data, score, fp_ms, smi)

    # -- 19. Weave, DAG, DTNN and the fit-transform regressor ------------
    phase_start(19)
    from deepchem_tpu_torch import DTNNModel, WeaveModel
    from deepchem_tpu_torch.models import MultitaskFitTransformRegressor
    from deepchem_tpu_torch.trans import CoulombFitTransformer
    wv_X, wv_y, wv_first, wv_small = weave_data()

    def wv_make(d, seed, **kw):
        return WeaveModel(**dict(WEAVE, **kw), device=d, seed=seed)
    # the whole set packs to A 32 and A 48, which fit_on_device cannot
    # stack, as in the JAX package: it trains on the A 32 molecules
    wv_probe = wv_make(dev, 0)
    wv_sizes = sorted({b[0][0].shape[1] for b in wv_probe.default_generator(
        NumpyDataset(wv_X, wv_y))})
    try:
        wv_probe.fit_on_device(NumpyDataset(wv_X, wv_y), nb_epoch=1)
        refused = False
    except ValueError:
        refused = True
    del wv_probe
    print(f'phase 19 weave: batches of {WEAVE["batch_size"]} pack to A '
          f'{wv_sizes}; fit_on_device over them refused: {refused}; it '
          f'trains on the {len(wv_small[0])} molecules of at most 32 '
          'atoms', flush=True)
    check(wv_sizes == [32, 48] and refused,
          'Weave: the 768 pack to A 32 and 48, and fit_on_device refuses '
          'them')
    new_runs = {}
    t0 = time.perf_counter()
    new_runs['weave'] = model_phase(
        19, 'weave', wv_make, wv_X, wv_y, {}, {}, smi,
        out_tail=(WEAVE['n_tasks'], 2),
        metrics=[Metric(roc_auc_score, np.mean)], on_device=wv_small,
        score_rows=wv_first)
    print(f'phase 19 weave: {time.perf_counter() - t0:.1f} s', flush=True)
    # DAG: P2 once a level pass and, in the backward, once for each
    # pass's source gather; P3 once for the sum readout
    per_batch = {'fused_gather_segment_sum': DAG_LEVELS,
                 'csr_segment_sum': 1}
    t0 = time.perf_counter()
    new_runs['dag'] = model_phase(
        19, 'dag', lambda d, seed, **kw: DAGModel(**DAG, device=d, seed=seed,
                                                 **kw),
        dag_X, dag_y, per_batch,
        dict(per_batch, fused_gather_segment_sum_bwd=DAG_LEVELS), smi)
    print(f'phase 19 dag: {time.perf_counter() - t0:.1f} s', flush=True)
    cm_X, cm_y, cm_mols, cm_ms = coulomb_data()
    print(f'phase 19 coulomb ({smi}): {cm_mols} molecules of at most '
          f'{QM7_ATOMS} atoms embedded and featurized in {cm_ms:.3f} ms a '
          f'molecule, repeated to {len(cm_X)}', flush=True)
    t0 = time.perf_counter()
    # DTNN: a step sums each element's embedding rows by P2 over a CSR of
    # the atoms by atomic number (gather_table_rows: index_add_'s float
    # atomics differed run to run)
    new_runs['dtnn'] = model_phase(
        19, 'dtnn', lambda d, seed, **kw: DTNNModel(**DTNN, device=d,
                                                   seed=seed, **kw),
        cm_X, cm_y, {}, {'fused_gather_segment_sum_bwd': 1}, smi,
        same_bits=True)
    print(f'phase 19 dtnn: {time.perf_counter() - t0:.1f} s', flush=True)
    cft = CoulombFitTransformer(NumpyDataset(cm_X, cm_y))
    t0 = time.perf_counter()
    new_runs['fit_transform'] = model_phase(
        19, 'fit_transform',
        lambda d, seed, **kw: MultitaskFitTransformRegressor(
            **FIT_TRANSFORM, fit_transformers=[cft], device=d, seed=seed,
            **kw), cm_X, cm_y, {}, {}, smi)
    print(f'phase 19 fit_transform: {time.perf_counter() - t0:.1f} s',
          flush=True)

    # -- 20. materials models and InfoMax3D --------------------------------
    phase_start(20)
    from deepchem_tpu_torch import ElemNetModel, InfoMax3DModular, LCNNModel
    from deepchem_tpu_torch.models import MultitaskRegressor
    print(f'phase 20 data ({smi}): {len(mat["sizes"])} structures of '
          f'{min(mat["sizes"])}-{max(mat["sizes"])} atoms repeated to '
          f'{CRYSTAL_COUNT}, {mat["edges_per_atom"]:.2f} CGCNN edges an '
          f'atom; the 48 SMILES embedded and shuffled to '
          f'{CONFORMER_MOLECULES}; featurize ms a structure or molecule '
          f'{json.dumps(mat["featurize_ms"])}', flush=True)
    mat_runs = {}

    def timed_phase(tag, *args, **kwargs):
        t0 = time.perf_counter()
        mat_runs[tag] = model_phase(20, tag, *args, **kwargs)
        print(f'phase 20 {tag}: {time.perf_counter() - t0:.1f} s',
              flush=True)
    # CGCNN: P2 once a convolution (the edge sum), twice in its backward
    # (the gathers by destination and by source); P3 twice for the mean
    # readout (sums and counts)
    per_batch = {'fused_gather_segment_sum': 3, 'csr_segment_sum': 2}
    # CGCNN and LCNN sum 12 messages into each atom a layer: activations
    # of tens to hundreds, so their answers and scores are held scaled
    timed_phase('cgcnn', lambda d, seed, **kw: CGCNNModel(
        **CGCNN, device=d, seed=seed, **kw), mat['cgcnn'], mat_y, per_batch,
        dict(per_batch, fused_gather_segment_sum_bwd=6), smi, scaled=True)
    # LCNN's and MEGNet's answers after 3 epochs barely correlate with the
    # labels or barely vary (MEGNet's spread 0.0024), so their pearson r2
    # is ill-conditioned: float32 alone moves MEGNet's by 4.4e-6 from
    # float64 (scripts/materials_float32_drift.py), and card and CPU read
    # 6.8e-6 and 1.1e-5 apart on an H100; they are scored by RMS and
    # MAE
    rms_mae = [Metric(rms_score), Metric(mae_score)]
    per_batch = {'fused_gather_segment_sum': 2, 'csr_segment_sum': 2}
    timed_phase('lcnn', lambda d, seed, **kw: LCNNModel(
        **LCNN, device=d, seed=seed, **kw), mat['lcnn'], mat_y, per_batch,
        dict(per_batch, fused_gather_segment_sum_bwd=4), smi, scaled=True,
        metrics=rms_mae)
    # MEGNet: P2 into the nodes, twice in the backward (the block's
    # gathers); P3 twice for the block's graph mean of h (33 segments: the
    # ghost slot's too), once for the edges into the graphs (over the node
    # sums) and twice for the readout
    per_batch = {'fused_gather_segment_sum': 1, 'csr_segment_sum': 5}
    timed_phase('megnet', lambda d, seed, **kw: MEGNetModel(
        **MEGNET, device=d, seed=seed, **kw), mat['cgcnn'], mat_y,
        per_batch, dict(per_batch, fused_gather_segment_sum_bwd=2), smi,
        overfit_steps=MEGNET_OVERFIT_STEPS, metrics=rms_mae, same_bits=True)
    # ElemNet's and InfoMax3D pretraining's runs are chaotic by their third
    # epoch: a 1e-7 change of the weights moves its loss by up to 4.9e-4
    # and 3.4e-4 (scripts/materials_float32_drift.py, the CPU, 4 seeds;
    # an H100 run missed ElemNet's by 4.0e-4), their second by 4.5e-6
    # and 4.0e-5: the losses are held to the CPU's over 2 epochs and 1
    timed_phase('elemnet', lambda d, seed, **kw: ElemNetModel(
        **ELEMNET, device=d, seed=seed, **kw), mat['elemnet'], mat_y, {}, {},
        smi, loss_epochs=2, timed_epochs=1)
    for key in ('sine_coulomb', 'element_property'):
        width = mat[key].shape[1]
        timed_phase(key, lambda d, seed, w=width, **kw: MultitaskRegressor(
            n_features=w, **MATERIAL_REGRESSOR, device=d, seed=seed, **kw),
            mat[key], mat_y, {}, {}, smi)
    # ElemNet at the JAX module's dropout, 0.2: training draws masks (the
    # outputs in train() mode differ from eval()'s), eval() draws none
    # (the same weights at dropout 0 answer alike), and a fit's losses are
    # finite
    drop = ElemNetModel(n_tasks=1, device=dev, seed=0)
    plain = ElemNetModel(**ELEMNET, device=dev, seed=0)
    x32 = torch.from_numpy(mat['elemnet'][:32]).to(dev)
    with torch.no_grad():
        drop.module.train()
        trained_out = drop.module(x32)
        drop.module.eval()
        eval_out = drop.module(x32)
    same_eval = bool(torch.equal(eval_out, plain.module.eval()(x32)))
    drop_losses = []
    drop.fit(NumpyDataset(mat['elemnet'], mat_y), nb_epoch=1,
             checkpoint_interval=0, all_losses=drop_losses)
    print(f'phase 20 elemnet at dropout 0.2: eval outputs equal the '
          f'dropout-free model\'s {same_eval}; train outputs differ '
          f'{not torch.equal(trained_out, eval_out)}; epoch loss '
          f'{drop_losses}', flush=True)
    check(same_eval and not torch.equal(trained_out, eval_out)
          and bool(np.all(np.isfinite(drop_losses))),
          'ElemNet: dropout 0.2 only in training, finite losses')
    del drop, plain
    # InfoMax3D pretraining: the 2D encoder's PNA layers P2 2 and K3 2
    # each (3 more P2 in the backward: the gathers of h by source and
    # destination and of the mean by destination), its mean
    # readout P3 2; the 3D encoder's layers P2 1 each (2 more in the
    # backward), its sum readout P3 1
    im_X, im_y = mat['conformer'], mat['conformer_y']
    per_batch = {'fused_gather_segment_sum': 9, 'graph_max_pool_fwd': 6,
                 'csr_segment_sum': 3}
    timed_phase('infomax3d_pretrain', lambda d, seed, **kw: InfoMax3DModular(
        task='pretrain', **INFOMAX3D, device=d, seed=seed, **kw), im_X,
        im_y, per_batch, dict(per_batch, fused_gather_segment_sum_bwd=15,
                              graph_max_pool_bwd=6), smi, scored=False,
        loss_epochs=1, same_bits=True, timed_epochs=1)
    # the regressor's encoder is pretrained on the CPU, so its weights are
    # the same on every run: pretraining on the card (timed above) is not
    # bit-reproducible, and from one such run's weights the regressor's
    # step-1 gradients, held to the CPU's from the same weights, moved by
    # 3.2e-5 of max(1, |g|) on an H100 (5e-8 in two other runs), as near
    # a tie of PNA's max or min
    pretrained = InfoMax3DModular(task='pretrain', **INFOMAX3D,
                                  device='cpu', seed=0)
    pre_losses = []
    pretrained.fit(NumpyDataset(im_X, im_y), nb_epoch=1,
                   checkpoint_interval=0, all_losses=pre_losses)

    def im_make(d, seed, **kw):
        m = InfoMax3DModular(task='regression', n_tasks=1, **INFOMAX3D,
                             device=d, seed=seed, **kw)
        m.load_from_pretrained(pretrained)
        return m
    carried = im_make(dev, 0).module.state_dict()
    src = pretrained.module.state_dict()
    same = all(torch.equal(v.cpu(), src[k]) for k, v in carried.items()
               if k.startswith('encoder2d.'))
    print(f'phase 20 infomax3d: pretrained 1 epoch (loss {pre_losses}), '
          f'its encoder2d carried into the regressor: {same}', flush=True)
    check(same and bool(np.all(np.isfinite(pre_losses))),
          'InfoMax3D: load_from_pretrained carries encoder2d')
    per_batch = {'fused_gather_segment_sum': 6, 'graph_max_pool_fwd': 6,
                 'csr_segment_sum': 2}
    timed_phase('infomax3d_regression', im_make, im_X, im_y, per_batch,
                dict(per_batch, graph_max_pool_bwd=6,
                     fused_gather_segment_sum_bwd=9), smi, same_bits=True)

    # -- 21. MXMNet, AtomicConv, the few-shot classifier, EGNN --------------
    phase_start(21)
    from deepchem_tpu_torch import AtomicConvModel, MXMNetModel
    s21 = slice21_data()
    lig = [a for a, _ in s21['complex_atoms']]
    pocket = [b for _, b in s21['complex_atoms']]
    print(f'phase 21 data ({smi}): the 48 SMILES embedded for MXMNet and '
          f'shuffled to {MXMNET_MOLECULES}; {ATOMIC_COMPLEXES} complexes '
          f'written as PDB text, ligands of {min(lig)}-{max(lig)} and '
          f'pockets of {min(pocket)}-{max(pocket)} heavy atoms; '
          f'{FEWSHOT_MOLECULES} molecules with labels for {FEWSHOT_TASKS} '
          f'tasks; featurize ms a molecule or complex '
          f'{json.dumps(s21["featurize_ms"])}', flush=True)
    slice_runs = {}

    def slice_phase(tag, run, *args, **kwargs):
        t0 = time.perf_counter()
        slice_runs[tag] = run(*args, **kwargs)
        print(f'phase 21 {tag}: {time.perf_counter() - t0:.1f} s',
              flush=True)
    # MXMNet: each plex's message sum P2 (2 plexes, 3 layers), its
    # gathers of h by source and destination P2 in the backward, the sum
    # readout P3
    per_batch = {'fused_gather_segment_sum': 6, 'csr_segment_sum': 1}
    slice_phase('mxmnet', model_phase, 21, 'mxmnet',
                lambda d, seed, **kw: MXMNetModel(**MXMNET, device=d,
                                                  seed=seed, **kw),
                s21['mxmnet'], s21['mxmnet_y'], per_batch,
                dict(per_batch, fused_gather_segment_sum_bwd=12), smi,
                same_bits=True)
    # AtomicConv: no kernel of the port's; its radial product is cuBLAS
    slice_phase('atomic_conv', model_phase, 21, 'atomic_conv',
                lambda d, seed, **kw: AtomicConvModel(**ATOMIC_CONV,
                                                      device=d, seed=seed,
                                                      **kw),
                s21['complexes'], s21['complexes_y'], {}, {}, smi,
                same_bits=True)
    for kind in ('siamese', 'attn', 'res'):
        slice_phase(f'fewshot_{kind}', fewshot_phase, kind, s21['fewshot'],
                    s21['fewshot_y'], smi)
    slice_phase('egnn', egnn_phase, s21['egnn'], smi)

    # -- 22. grover, mat -------------------------------------------------
    phase_start(22)
    g_runs, (grover_k1, grover_p2, grover_p3), grover_remat = \
        grover_mat_phase(dev, smi)

    # -- 23. sequence and image models ----------------------------------
    phase_start(23)
    seq_runs, seq_p2 = seq_image_phase(dev, smi)

    # -- 24. the data layer and the MoleculeNet harness -----------------
    phase_start(24)
    molnet = molnet_phase(dev, smi)

    # -- 25. kernels line -------------------------------------------------
    phase_start(25)
    print(f'chip_smoke wall: {time.perf_counter() - _START:.1f} s of its '
          f'1200', flush=True)
    print(f'device_us readings from windows with records missing: '
          f'{len(PARTIAL_WINDOWS)} {json.dumps(PARTIAL_WINDOWS)}', flush=True)
    def run_paths(runs, key):
        return {f'{m}_{run}': counts[key] for m, (srv, fit, dev_fit, _) in
                runs.items() for run, counts in (
                    ('serve', srv), ('fit', fit), ('fit_on_device', dev_fit))
                if counts[key]}

    def entry(kname, cases, main_case, path_launches, source=None, **extra):
        return {'name': kname, 'route': 'cuda',
                'source': source or f'deepchem_tpu_torch/csrc/{kname}.cu',
                'launches': sum(path_launches.values()),
                'launches_by_path': path_launches,
                'max_abs_err': max(c['max_abs_err'] for c in cases),
                'ms': main_case['ms'], 'device_us': main_case['device_us'],
                'plain_ms': main_case['plain_ms'],
                'bound_ms': main_case['bound_ms'],
                'bound_by': main_case['bound_by'],
                'library_ms': main_case['library_ms'],
                **{k: main_case[k] for k in ('library_device_us',
                                             'backward_device_us')
                   if k in main_case}, **extra}
    p1 = entry('csr_segment_softmax', softmax_cases, softmax_cases[0],
               {'serve': serve['csr_segment_softmax'],
                'train': train['csr_segment_softmax'],
                'mpnn_serve': mp_serve['csr_segment_softmax'],
                'mpnn_train': mp_train['csr_segment_softmax'],
                **run_paths(branch_runs, 'csr_segment_softmax')},
               replaces='deepchem_tpu/ops/pallas_segment.py:156',
               coo_branches={c['case']: {k: c[k] for k in (
                   'E', 'H', 'N', 'ms', 'device_us', 'plain_ms', 'bound_ms',
                   'bound_by', 'library_ms', 'library_device_us',
                   'max_abs_err') if k in c} for c in coo_branch_cases[4:]},
               backward={'route': 'torch.autograd.Function: dx = y * (dy - '
                                  't[seg]), t from csr_segment_sum (cuda)',
                         'max_abs_err': max(c['max_abs_err']
                                            for c in backward_cases)})
    def table_paths(key):
        return run_paths(table_runs, key)

    def coo_paths(key):
        return run_paths(coo_runs, key)
    p3 = entry('csr_segment_sum',
               sum_cases + dag_sum_cases + mat_sum_cases + grover_p3,
               sum_cases[0],
               {'serve': serve['csr_segment_sum'],
                'train': train['csr_segment_sum'],
                'graphconv_serve': gc_serve['csr_segment_sum'],
                'graphconv_train': gc_train['csr_segment_sum'],
                'mpnn_serve': mp_serve['csr_segment_sum'],
                'mpnn_train': mp_train['csr_segment_sum'],
                **table_paths('csr_segment_sum'),
                'graphconv_engine': engine['csr_segment_sum'],
                'molnet_fit_on_device': molnet['csr_segment_sum'],
                **coo_paths('csr_segment_sum'),
                **run_paths(branch_runs, 'csr_segment_sum'),
                **run_paths(new_runs, 'csr_segment_sum'),
                **run_paths(mat_runs, 'csr_segment_sum'),
                **run_paths(slice_runs, 'csr_segment_sum'),
                **run_paths(g_runs, 'csr_segment_sum')},
               replaces='deepchem_tpu/ops/pallas_segment.py:45',
               shapes={c['case']: {k: c[k] for k in (
                   'N', 'E', 'F', 'ms', 'device_us', 'plain_ms', 'bound_ms',
                   'bound_by', 'library_ms', 'library_device_us',
                   'max_abs_err')}
                   for c in dag_sum_cases + mat_sum_cases + grover_p3})
    # P2: main case GNNModular's layer-1 sum at batch 100; its launches on
    # the COO models' forwards and (the transpose) backwards
    p2 = entry('fused_gather_segment_sum',
               gather_cases + p2_long_cases + coo_cases
               + coo_branch_cases[:4] + dag_cases + mat_cases + grover_p2
               + seq_p2,
               coo_cases[1],
               {'p2_bench_shapes': p2_path['fused_gather_segment_sum'],
                **coo_paths('fused_gather_segment_sum'),
                **{f'{path}_backward': n for path, n in
                   coo_paths('fused_gather_segment_sum_bwd').items()},
                **run_paths(branch_runs, 'fused_gather_segment_sum'),
                **{f'{path}_backward': n for path, n in run_paths(
                    branch_runs, 'fused_gather_segment_sum_bwd').items()},
                **run_paths(new_runs, 'fused_gather_segment_sum'),
                **{f'{path}_backward': n for path, n in run_paths(
                    new_runs, 'fused_gather_segment_sum_bwd').items()},
                **run_paths(mat_runs, 'fused_gather_segment_sum'),
                **{f'{path}_backward': n for path, n in run_paths(
                    mat_runs, 'fused_gather_segment_sum_bwd').items()},
                **run_paths(slice_runs, 'fused_gather_segment_sum'),
                **{f'{path}_backward': n for path, n in run_paths(
                    slice_runs, 'fused_gather_segment_sum_bwd').items()},
                **{f'{path}_backward': n for path, n in run_paths(
                    g_runs, 'fused_gather_segment_sum_bwd').items()},
                **{f'{path}_backward': n for path, n in run_paths(
                    seq_runs, 'fused_gather_segment_sum_bwd').items()}},
               replaces='deepchem_tpu/ops/pallas_segment.py:94',
               shapes={c['case']: {k: c[k] for k in (
                   'N', 'E', 'F', 'ms', 'device_us', 'plain_ms', 'bound_ms',
                   'bound_by', 'library_ms', 'library_device_us',
                   'library_over_kernel')}
                   for c in gather_cases[:len(P2_BENCH_SHAPES)]
                   + p2_long_cases + coo_cases + coo_branch_cases[:4]
                   + dag_cases + mat_cases + grover_p2 + seq_p2},
               models={m: numbers for m, (_, _, _, numbers) in
                       (coo_runs | branch_runs | new_runs | mat_runs
                        | slice_runs).items()})
    # P2 in bfloat16: the JAX package's bench shapes, the long segments
    # and the non-finite inputs; main case the widest bench shape
    p2_bf16 = entry('fused_gather_segment_sum_bf16', bf16_cases,
                    bf16_cases[len(P2_BENCH_SHAPES) - 1],
                    {'p2_bench_shapes_bf16':
                     p2_bf16_path['fused_gather_segment_sum_bf16']},
                    source='deepchem_tpu_torch/csrc/'
                           'fused_gather_segment_sum.cu',
                    replaces='deepchem_tpu/ops/pallas_segment.py:94 '
                             '(bfloat16 h)',
                    add_ns=add_ns,
                    shapes={c['case']: {k: c[k] for k in (
                        'N', 'E', 'F', 'longest_segment', 'ms', 'device_us',
                        'plain_ms', 'bound_ms', 'bound_by', 'launch_floor_ms',
                        'order_bound_ms', 'least_ms', 'least_by',
                        'share_of_least', 'library_ms', 'library_device_us',
                        'err_f64', 'library_err_f64')}
                        for c in bf16_cases})
    # P4: the stock kernels, reached through bert_encoder.py:62; main case
    # the encoder's attention in bfloat16
    stock = {'fwd': 758, 'dkv': 1121, 'dq': 1456}
    f32_main = flash_cases[1]            # the encoder's attention in float32
    p4 = tuple(entry(
        f'flash_attention_{part}',
        [c[part] for c in flash_cases if part in c],
        flash_cases[0][part],
        {path: counts[f'flash_attention_{part}'] for path, counts in
         (('serve_flash', serve_flash), ('train_flash', train_flash),
          ('train_flash_f32', train_flash_f32), ('crossover', p4_path))},
        source='deepchem_tpu_torch/csrc/flash_attention.cu',
        replaces=f'jax/experimental/pallas/ops/tpu/flash_attention.py:'
                 f'{line} via deepchem_tpu/models/bert_encoder.py:62',
        float32={**{k: f32_main[part][k] for k in (
            'device_us', 'bound_ms', 'bound_by', 'library_device_us',
            'max_abs_err', 'err_f64')}, 'launches_by_path': {
                path: counts[f'flash_attention_{part}'] for path, counts in
                (('serve_flash', serve_flash),
                 ('train_flash_f32', train_flash_f32))}})
        for part, line in stock.items())
    # K1-K3: custom-VJP XLA ops in the JAX package, no Pallas kernel
    def gc_paths(key):
        return {'graphconv_serve': gc_serve[key],
                'graphconv_train': gc_train[key],
                'graphconv_engine': engine[key],
                'molnet_fit_on_device': molnet[key]}
    xla_op = 'a custom-VJP XLA op, no Pallas kernel'
    fwd_max = [c[0] for c in max_cases]
    bwd_max = [c[1] for c in max_cases]
    # K1's MPNN shape: nei_sum_edges over the incoming-edge table; GCN's
    # layer 0 (F 30) and DMPNN's F 300 edge rows
    k1_keys = ('N', 'R', 'F', 'slots', 'ms', 'device_us', 'plain_ms',
               'bound_ms', 'bound_by', 'library_ms', 'library_device_us',
               'max_abs_err')
    grover_k1_keys = ('grover_nei_sum_sym', 'grover_nei_sum_sym_bwd',
                      'grover_nei_sum_sym_g', 'grover_nei_sum_sym_g_bwd',
                      'grover_nei_sum_bonds', 'grover_nei_sum_bonds_g',
                      'grover_slot_sum')
    k1 = entry('nei_sum', nei_cases + new_k1_cases + grover_k1,
               nei_cases[0],
               {'graphconv_serve': gc_serve['nei_sum'],
                'graphconv_train': gc_train['nei_sum']
                + gc_train['nei_sum_bwd'],
                'graphconv_engine': engine['nei_sum']
                + engine['nei_sum_bwd'],
                'molnet_fit_on_device': molnet['nei_sum']
                + molnet['nei_sum_bwd'],
                'mpnn_serve': mp_serve['nei_sum_edges'],
                'mpnn_train': mp_train['nei_sum_edges']
                + mp_train['take_src_bwd'],
                **{f'{path}_nei_sum': n
                   for path, n in table_paths('nei_sum').items()},
                **{f'{path}_nei_sum_bwd': n
                   for path, n in table_paths('nei_sum_bwd').items()},
                **{f'{path}_nei_sum_edges': n
                   for path, n in table_paths('nei_sum_edges').items()},
                **{f'{path}_nei_gather_bwd': n
                   for path, n in table_paths('nei_gather_bwd').items()},
                **{f'{path}_{key[len("grover_"):]}': n for key in
                   grover_k1_keys for path, n in run_paths(
                       g_runs, key).items()}},
               source='deepchem_tpu_torch/csrc/nei_table.cu',
               replaces=f'deepchem_tpu/ops/nei_table.py:85 (nei_sum and '
                        f'its backward, _slot_sum :75; also nei_sum_edges '
                        f':214, take_src\'s backward :258 and '
                        f'_nei_gather_bwd :194; {xla_op}); '
                        f'deepchem_tpu/models/grover.py:270-403 '
                        f'(_nei_sum_sym, _nei_sum_bonds and their grouped '
                        f'twins, every slot summed; custom VJPs, no Pallas '
                        f'kernel)',
               mpnn={k: mp_nei_cases[0][k] for k in k1_keys},
               gcn={k: new_k1_cases[0][k] for k in k1_keys},
               dmpnn={k: new_k1_cases[-1][k] for k in k1_keys},
               grover={c['case']: {k: c[k] for k in k1_keys}
                       for c in grover_k1},
               models={m: numbers for m, (_, _, _, numbers) in
                       g_runs.items()},
               grover_remat=grover_remat)
    # K4: main case AttentiveFP's C 200; its backward is K1's kernel
    k4_fwd = [c[0] for c in k4_cases]
    k4_bwd = [c[1] for c in k4_cases]
    k4 = entry('nei_gather', k4_fwd, k4_fwd[-1], table_paths('nei_gather'),
               replaces=f'deepchem_tpu/ops/nei_table.py:171 (nei_gather '
                        f'forward; backward _nei_gather_bwd :194 on K1; '
                        f'{xla_op})',
               backward={
                   'route': 'cuda, deepchem_tpu_torch/csrc/nei_table.cu '
                            'nei_sum_kernel (K1) over the rows table * K + '
                            'rev_slot',
                   'launches_by_path': table_paths('nei_gather_bwd'),
                   **{k: k4_bwd[-1][k] for k in (
                       'ms', 'device_us', 'plain_ms', 'bound_ms', 'bound_by',
                       'library_ms', 'library_device_us')},
                   'max_abs_err': max(c['max_abs_err'] for c in k4_bwd)},
               shapes={f"{c['kernel']} {c['case']}": {k: c[k] for k in (
                   'C', 'device_us', 'bound_ms', 'library_device_us')}
                   for c in k4_fwd + k4_bwd},
               models={m: numbers for m, (_, _, _, numbers) in
                       table_runs.items()})
    k2 = (entry('nei_max_fwd', fwd_max, fwd_max[0], gc_paths('nei_max_fwd'),
                source='deepchem_tpu_torch/csrc/nei_table.cu',
                replaces=f'deepchem_tpu/ops/nei_table.py:104 '
                         f'(nei_max_incl_self, _nei_max_fwd_impl :112; '
                         f'{xla_op})'),
          entry('nei_max_bwd', bwd_max, bwd_max[0], gc_paths('nei_max_bwd'),
                source='deepchem_tpu_torch/csrc/nei_table.cu',
                replaces=f'deepchem_tpu/ops/nei_table.py:132 '
                         f'(_nei_max_bwd; {xla_op})'))
    k3 = tuple(entry(
        f'graph_max_pool_{part}', [c[i] for c in pool_cases]
        + [pna_pool_cases[i], gc_pool_cases[i], im_pool_cases[i]],
        pool_cases[0][i],
        dict(gc_paths(f'graph_max_pool_{part}'),
             **coo_paths(f'graph_max_pool_{part}'),
             **run_paths(branch_runs, f'graph_max_pool_{part}'),
             **run_paths(mat_runs, f'graph_max_pool_{part}')),
        coo_branches={gc_pool_cases[i]['case']: {k: gc_pool_cases[i][k] for
                                                 k in (
            'N', 'F', 'G', 'ms', 'device_us', 'plain_ms', 'bound_ms',
            'bound_by', 'library_ms', 'library_device_us', 'max_abs_err')
            if k in gc_pool_cases[i]}},
        pna={k: pna_pool_cases[i][k] for k in (
            'N', 'F', 'G', 'ms', 'device_us', 'plain_ms', 'bound_ms',
            'bound_by', 'library_ms', 'library_device_us', 'max_abs_err')
            if k in pna_pool_cases[i]},
        shapes={im_pool_cases[i]['case']: {k: im_pool_cases[i][k] for k in (
            'N', 'F', 'G', 'ms', 'device_us', 'plain_ms', 'bound_ms',
            'bound_by', 'library_ms', 'library_device_us', 'max_abs_err')
            if k in im_pool_cases[i]}},
        source='deepchem_tpu_torch/csrc/graph_pool.cu',
        replaces=f'deepchem_tpu/ops/segment.py:173 (segment_max_sumgrad '
                 f'{"forward" if part == "fwd" else "backward"} in '
                 f'graph_pool(..., "max") :214; {xla_op})')
        for i, part in enumerate(('fwd', 'bwd')))
    print(json.dumps({'kernels': [
        {k: e[k] for k in ('name', 'route', 'source', 'replaces', 'launches',
                           'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                           'bound_by', 'library_ms')}
        | {k: v for k, v in e.items() if k in (
            'device_us', 'launches_by_path', 'backward', 'library_device_us',
            'backward_device_us', 'float32', 'mpnn', 'gcn', 'dmpnn', 'pna',
            'grover',
            'shapes', 'models', 'coo_branches')}
        for e in (p1, p3, p2, p2_bf16) + p4 + (k1,) + k2 + k3 + (k4,)]}),
        flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
