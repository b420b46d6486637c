'''Stop-word tables for the remaining reference locales.

Public-domain stop-word lists (Snowball project / ISO 639 community
lists) — the same data the reference ships as .txt and codegens at
build time (build.rs:6-76). Data, not code; merged into the table
registry by stop_words.py.

Port of ``orama_core_tpu/nlp/stop_words_extra.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
'''

TABLES = {}

TABLES["ar"] = frozenset("""
، ـ ء ءَ آ أ ا ا? االا االتى آب أبٌ ابتدأ أبدا أبريل أبو ابين اتخذ
اثر اثنا اثنان اثني اثنين أجل اجل أجمع أحد احد إحدى أخٌ أخبر أخذ آخر
اخرى اخلولق أخو إذ إذا إذاً اذا آذار إذما إذن أربع أربعاء أربعة اربعة
أربعمائة أربعمئة اربعون اربعين ارتدّ أرى إزاء استحال أسكن أصبح اصبح
أصلا آض إضافي أضحى اضحى اطار أطعم اعادة أعطى أعلم اعلنت أغسطس أُفٍّ
أفٍّ اف أفريل أفعل به أقبل أكتوبر أكثر اكثر اكد آل أل ألا إلا إلّا الا
الاخيرة الألاء الألى الآن الان الاول الاولى التي التى الثاني الثانية
الحالي الذاتي الذي الذى الذين السابق ألف الف ألفى اللاتي اللتان اللتيا
اللتين اللذان اللذين اللواتي الماضي المقبل الوقت إلي إلى الي الى
إلَيْكَ إليكَ إليكم إليكما إليكنّ اليه اليها اليوم أم أما أمّا إما
إمّا اما أمام امام أمامك أمامكَ أمد أمس امس أمسى امسى آمينَ أن أنًّ إن
إنَّ ان أنا آناء أنبأ انبرى أنت أنتِ انت أنتم أنتما أنتن أنشأ آنفا
أنفسكم أنفسنا أنفسهم انقلب أنه إنه انه أنها إنها انها أنّى آه آهٍ آهِ
آهاً أهلا أو او أوت أوشك أول اول أولاء أولالك أولئك أوّهْ أي أيّ أى إى
اي اى ا?ى أيا أيار ايار إياك إياكم إياكما إياكن ايام ّأيّان أيّان
إيانا إياه إياها إياهم إياهما إياهن إياي أيضا ايضا أيلول أين إيهٍ ب
باء بات باسم بأن بإن بان بخٍ بد بدلا برس بَسْ بسّ بسبب بشكل بضع بطآن
بعد بعدا بعض بعيدا بغتة بل بَلْهَ بلى بن به بها بهذا بؤسا بئس بيد بين
بينما ة ت تاء تارة تاسع تانِ تانِك تبدّل تجاه تحت تحت' تحوّل تخذ ترك
تسع تسعة تسعمائة تسعمئة تسعون تسعين تشرين تعسا تعلَّم تفعلان تفعلون
تفعلين تكون تلقاء تلك تم تموز تِه تِي تَيْنِ تينك ث ثاء ثالث ثامن ثان
ثاني ثانية ثلاث ثلاثاء ثلاثة ثلاثمائة ثلاثمئة ثلاثون ثلاثين ثم ثمَّ
ثمّ ثمان ثمانمئة ثمانون ثماني ثمانية ثمانين ثمّة ثمنمئة ج جانفي جدا
جعل جلل جمعة جميع جنيه جوان جويلية جير جيم ح حاء حادي حار حاشا حاليا
حاي حبذا حبيب حتى حجا حدَث حَذارِ حرى حزيران حسب حقا حمٌ حمدا حمو
حوالى حول حيَّ حيث حيثما حين خ خاء خارج خاصة خال خامس خبَّر خلا خلافا
خلال خلف خمس خمسة خمسمائة خمسمئة خمسون خمسين خميس د دال درهم درى
دواليك دولار دون دونك ديسمبر ديك دينار ذ ذا ذات ذاك ذال ذانِ ذانك ذلك
ذِه ذهب ذو ذِي ذيت ذَيْنِ ذينك ر راء رابع راح رأى رُبَّ رجع رزق رويدك
ريال ريث ز زاي زعم زود زيارة س ساء سابع سادس سبت سبتمبر سبحان سبع سبعة
سبعمائة سبعمئة سبعون سبعين ست ستة ستكون ستمائة ستمئة ستون ستين سحقا
سرا سرعان سقى سمعا سنة سنتيم سنوات سوف سوى سين ش شباط شبه شَتَّانَ
شتانَ شخصا شرع شمال شيكل شين ص صاد صار صباح صباحا صبر صبرا صدقا صراحة
صفر صهٍ صهْ ض ضاد ضحوة ضد ضمن ط طاء طاق طالما طرا طفق طَق ظ ظاء ظل ظلّ
ظنَّ ع عاد عاشر عام عاما عامة عجبا عدَّ عدا عدة عدد عَدَسْ عدم عسى عشر
عشرة عشرون عشرين عل علًّ علق علم علي على عليك عليه عليها عن عند عندما
عنه عنها عوض عيانا عين غ غادر غالبا غدا غداة غير غين ف فاء فأن فإن فان
فانه فبراير فرادى فضلا فعل فقد فقط فكان فلان فلس فما فهو فهي فهى فو
فوق في فى فيفري فيه فيها ق قاطبة قاف قال قام قبل قد قرش قطّ قلما قليل
قوة ك كاد كاف كأن كأنّ كان كانت كانون كأيّ كأيّن كثيرا كِخ كذا كذلك
كرب كسا كل كلا كلَّا كلتا كلم كلّما كم كما كن كى كيت كيف كيفما ل لا
لات لازال لاسيما لا سيما لام لأن لايزال لبيك لدن لدي لدى لديه لذلك لعل
لعلَّ لعمر لقاء لك لكن لكنَّ لكنه للامم لم لما لمّا لماذا لن لنا له
لها لهذا لهم لو لوكالة لولا لوما لي ليت ليرة ليس ليسب م ما ما أفعله
ماانفك ما انفك مابرح ما برح مادام ماذا مارس مازال مافتئ ماي مائة
مايزال مايو متى مثل مذ مرة مرّة مساء مع معاذ معظم معه معها مقابل
مكانَك مكانكم مكانكما مكانكنّ مليار مليم مليون مما من منذ منه منها مه
مهما مئة مئتان ميم ن نَّ نا نبَّا نحن نحو نَخْ نعم نفس نفسك نفسه نفسها
نفسي نهاية نوفمبر نون نيسان نيف ه ها هاء هَاتانِ هَاتِه هَاتِي
هَاتَيْنِ هاكَ هبّ هَجْ هذا هَذا هَذانِ هذه هَذِه هَذِي هَذَيْنِ هكذا
هل هلّا هللة هلم هم هما همزة هن هنا هناك هنالك هو هؤلاء هَؤلاء هي هى
هيا هيّا هيهات هَيْهات ؤ و و6 وا وأبو واحد واضاف واضافت واكد والتي
والذي وأن وإن وان واهاً واو واوضح وبين وثي وجد وجود وراءَك ورد
وُشْكَانَ وعلى وفي وقال وقالت وقد وقف وكان وكانت وكل ولا ولايزال ولكن
ولم ولن وله وليس وما ومع ومن وهب وهذا وهو وهي وهى وَيْ ي ى ئ ياء يجري
يفعلان يفعلون يكون يلي يمكن يمين ين يناير ينبغي يوان يورو يوليو يوم
يونيو
""".split())

TABLES["bg"] = frozenset("""
а автентичен аз ако ала бе без беше би бивш бивша бившо бил била били
било благодаря близо бъдат бъде бяха в вас ваш ваша вероятно вече
взема ви вие винаги внимава време все всеки всички всичко всяка във
въпреки върху г ги главен главна главно глас го година години годишен
д да дали два двама двамата две двете ден днес дни до добра добре
добро добър докато докога дори досега доста друг друга други е евтин
едва един една еднаква еднакви еднакъв едно екип ето живот за забавям
зад заедно заради засега заспал затова защо защото и из или им има
имат иска й каза как каква какво както какъв като кога когато което
които кой който колко която къде където към лесен лесно ли лош м май
малко ме между мек мен месец ми много мнозина мога могат може мокър
моля момента му н на над назад най направи напред например нас не него
нещо нея ни ние никой нито нищо но нов нова нови новина някои някой
няколко няма обаче около освен особено от отгоре отново още пак по
повече повечето под поне поради после почти прави пред преди през при
пък първата първи първо пъти равен равна с са сам само се сега си син
скоро след следващ сме смях според сред срещу сте съм със също т т.н.
тази така такива такъв там твой те тези ти то това тогава този той
толкова точно три трябва тук тъй тя тях у утре харесва хиляди ч часа
че често чрез ще щом юмрук я як
""".split())

TABLES["da"] = frozenset("""
ad af aldrig alle alt anden andet andre at bare begge blev blive
bliver da de dem den denne der deres det dette dig din dine disse dit
dog du efter ej eller en end ene eneste enhver er et far fem fik fire
flere fleste for fordi forrige fra få får før god godt ham han hans
har havde have hej helt hende hendes her hos hun hvad hvem hver
hvilken hvis hvor hvordan hvorfor hvornår i ikke ind ingen intet ja
jeg jer jeres jo kan kom komme kommer kun kunne lad lav lidt lige
lille man mand mange med meget men mens mere mig min mine mit mod må
ned nej ni nogen noget nogle nu ny nyt når nær næste næsten og også
okay om op os otte over på se seks selv ser ses sig sige sin sine sit
skal skulle som stor store syv så sådan tag tage thi ti til to tre ud
under var ved vi vil ville vor vores være været
""".split())

TABLES["el"] = frozenset("""
ένα έναν ένας αι ακομα ακομη ακριβως αληθεια αληθινα αλλα αλλαχου
αλλες αλλη αλλην αλλης αλλιως αλλιωτικα αλλο αλλοι αλλοιως αλλοιωτικα
αλλον αλλος αλλοτε αλλου αλλους αλλων αμα αμεσα αμεσως αν ανα αναμεσα
αναμεταξυ ανευ αντι αντιπερα αντις ανω ανωτερω αξαφνα απ απεναντι απο
αποψε από αρα αραγε αργα αργοτερο αριστερα αρκετα αρχικα ας αυριο αυτα
αυτες αυτεσ αυτη αυτην αυτης αυτο αυτοι αυτον αυτος αυτοσ αυτου αυτους
αυτουσ αυτων αφοτου αφου αἱ αἳ αἵ αὐτόσ αὐτὸς αὖ α∆ιακοπα βεβαια
βεβαιοτατα γάρ γα γα^ γε γι για γοῦν γρηγορα γυρω γὰρ δ' δέ δή δαί
δαίσ δαὶ δαὶς δε δεν δι δι' διά δια διὰ δὲ δὴ δ’ εαν εαυτο εαυτον
εαυτου εαυτους εαυτων εγκαιρα εγκαιρως εγω ειθε ειμαι ειμαστε ειναι
εις εισαι εισαστε ειστε ειτε ειχα ειχαμε ειχαν ειχατε ειχε ειχες
ει∆εμη εκ εκαστα εκαστες εκαστη εκαστην εκαστης εκαστο εκαστοι εκαστον
εκαστος εκαστου εκαστους εκαστων εκει εκεινα εκεινες εκεινεσ εκεινη
εκεινην εκεινης εκεινο εκεινοι εκεινον εκεινος εκεινοσ εκεινου
εκεινους εκεινουσ εκεινων εκτος εμας εμεις εμενα εμπρος εν ενα εναν
ενας ενος εντελως εντος εντωμεταξυ ενω ενός εξ εξαφνα εξης εξισου εξω
επ επί επανω επειτα επει∆η επι επισης επομενως εσας εσεις εσενα εστω
εσυ ετερα ετεραι ετερας ετερες ετερη ετερης ετερο ετεροι ετερον ετερος
ετερου ετερους ετερων ετουτα ετουτες ετουτη ετουτην ετουτης ετουτο
ετουτοι ετουτον ετουτος ετουτου ετουτους ετουτων ετσι ευγε ευθυς
ευτυχως εφεξης εχει εχεις εχετε εχθες εχομε εχουμε εχουν εχτες εχω εως
εἰ εἰμί εἰμὶ εἰς εἰσ εἴ εἴμι εἴτε ε∆ω η ημασταν ημαστε ημουν ησασταν
ησαστε ησουν ηταν ητανε ητοι ηττον η∆η θα ι ιι ιιι ισαμε ισια ισως
ισωσ ι∆ια ι∆ιαν ι∆ιας ι∆ιες ι∆ιο ι∆ιοι ι∆ιον ι∆ιος ι∆ιου ι∆ιους ι∆ιων
ι∆ιως κ καί καίτοι καθ καθε καθεμια καθεμιας καθενα καθενας καθενος
καθετι καθολου καθως και κακα κακως καλα καλως καμια καμιαν καμιας
καμποσα καμποσες καμποση καμποσην καμποσης καμποσο καμποσοι καμποσον
καμποσος καμποσου καμποσους καμποσων κανεις κανεν κανενα κανεναν
κανενας κανενος καποια καποιαν καποιας καποιες καποιο καποιοι καποιον
καποιος καποιου καποιους καποιων καποτε καπου καπως κατ κατά κατα κατι
κατιτι κατοπιν κατω κατὰ καὶ κι κιολας κλπ κοντα κτλ κυριως κἀν κἂν
λιγακι λιγο λιγωτερο λογω λοιπα λοιπον μέν μέσα μή μήτε μία μα μαζι
μακαρι μακρυα μαλιστα μαλλον μας με μεθ μεθαυριο μειον μελει μελλεται
μεμιας μεν μερικα μερικες μερικοι μερικους μερικων μεσα μετ μετά μετα
μεταξυ μετὰ μεχρι μη μην μηπως μητε μη∆ε μιά μια μιαν μιας μολις
μολονοτι μοναχα μονες μονη μονην μονης μονο μονοι μονομιας μονος μονου
μονους μονων μου μπορει μπορουν μπραβο μπρος μἐν μὲν μὴ μὴν να ναι
νωρις ξανα ξαφνικα ο οι ολα ολες ολη ολην ολης ολο ολογυρα ολοι ολον
ολονεν ολος ολοτελα ολου ολους ολων ολως ολως∆ιολου ομως ομωσ οποια
οποιαν οποιαν∆ηποτε οποιας οποιας∆ηποτε οποια∆ηποτε οποιες
οποιες∆ηποτε οποιο οποιοι οποιον οποιον∆ηποτε οποιος οποιος∆ηποτε
οποιου οποιους οποιους∆ηποτε οποιου∆ηποτε οποιο∆ηποτε οποιων
οποιων∆ηποτε οποι∆ηποτε οποτε οποτε∆ηποτε οπου οπου∆ηποτε οπως οπωσ
ορισμενα ορισμενες ορισμενων ορισμενως οσα οσα∆ηποτε οσες οσες∆ηποτε
οση οσην οσην∆ηποτε οσης οσης∆ηποτε οση∆ηποτε οσο οσοι οσοι∆ηποτε οσον
οσον∆ηποτε οσος οσος∆ηποτε οσου οσους οσους∆ηποτε οσου∆ηποτε οσο∆ηποτε
οσων οσων∆ηποτε οταν οτι οτι∆ηποτε οτου ου ουτε ου∆ε οχι οἱ οἳ οἷς οὐ
οὐδ οὐδέ οὐδείσ οὐδεὶς οὐδὲ οὐδὲν οὐκ οὐχ οὐχὶ οὓς οὔτε οὕτω οὕτως
οὕτωσ οὖν οὗ οὗτος οὗτοσ παλι παντοτε παντου παντως παρ παρά παρα παρὰ
περί περα περι περιπου περισσοτερο περσι περυσι περὶ πια πιθανον πιο
πισω πλαι πλεον πλην ποια ποιαν ποιας ποιες ποιεσ ποιο ποιοι ποιον
ποιος ποιοσ ποιου ποιους ποιουσ ποιων πολυ ποσες ποση ποσην ποσης
ποσοι ποσος ποσους ποτε που πουθε πουθενα ποῦ πρεπει πριν προ
προκειμενου προκειται προπερσι προς προσ προτου προχθες προχτες
πρωτυτερα πρόσ πρὸ πρὸς πως πωσ σαν σας σε σεις σημερα σιγα σου στα
στη στην στης στις στο στον στου στους στων συγχρονως συν συναμα
συνεπως συνηθως συχνα συχνας συχνες συχνη συχνην συχνης συχνο συχνοι
συχνον συχνος συχνου συχνους συχνων συχνως σχε∆ον σωστα σόσ σύ σύν σὸς
σὺ σὺν τά τήν τί τίς τίσ τα ταυτα ταυτες ταυτη ταυτην ταυτης
ταυτο,ταυτον ταυτος ταυτου ταυτων ταχα ταχατε ταῖς τα∆ε τε τελικα
τελικως τες τετοια τετοιαν τετοιας τετοιες τετοιο τετοιοι τετοιον
τετοιος τετοιου τετοιους τετοιων τη την της τησ τι τινα τιποτα τιποτε
τις τισ το τοί τοι τοιοῦτος τοιοῦτοσ τον τος τοσα τοσες τοση τοσην
τοσης τοσο τοσοι τοσον τοσος τοσου τοσους τοσων τοτε του τουλαχιστο
τουλαχιστον τους τουτα τουτες τουτη τουτην τουτης τουτο τουτοι τουτοις
τουτον τουτος τουτου τουτους τουτων τούσ τοὺς τοῖς τοῦ τυχον των τωρα
τό τόν τότε τὰ τὰς τὴν τὸ τὸν τῆς τῆσ τῇ τῶν τῷ υπ υπερ υπο υποψη
υποψιν υπό υστερα φετος χαμηλα χθες χτες χωρις χωριστα ψηλα ω ωραια ως
ωσ ωσαν ωσοτου ωσπου ωστε ωστοσο ωχ ἀλλ' ἀλλά ἀλλὰ ἀλλ’ ἀπ ἀπό ἀπὸ ἀφ
ἂν ἃ ἄλλος ἄλλοσ ἄν ἄρα ἅμα ἐάν ἐγώ ἐγὼ ἐκ ἐμόσ ἐμὸς ἐν ἐξ ἐπί ἐπεὶ
ἐπὶ ἐστι ἐφ ἐὰν ἑαυτοῦ ἔτι ἡ ἢ ἣ ἤ ἥ ἧς ἵνα ὁ ὃ ὃν ὃς ὅ ὅδε ὅθεν ὅπερ
ὅς ὅσ ὅστις ὅστισ ὅτε ὅτι ὑμόσ ὑπ ὑπέρ ὑπό ὑπὲρ ὑπὸ ὡς ὡσ ὥς ὥστε ὦ ᾧ
∆α ∆ε ∆εινα ∆εν ∆εξια ∆ηθεν ∆ηλα∆η ∆ι ∆ια ∆ιαρκως ∆ικα ∆ικο ∆ικοι
∆ικος ∆ικου ∆ικους ∆ιολου ∆ιπλα ∆ιχως
""".split())

TABLES["et"] = frozenset("""
aga ei et ja jah kas kui kõik ma me mida midagi mind minu mis mu mul
mulle nad nii oled olen oli oma on pole sa seda see selle siin siis ta
te ära
""".split())

TABLES["fi"] = frozenset("""
aiemmin aika aikaa aikaan aikaisemmin aikaisin aikajen aikana aikoina
aikoo aikovat aina ainakaan ainakin ainoa ainoat aiomme aion aiotte
aist aivan ajan alas alemmas alkuisin alkuun alla alle aloitamme
aloitan aloitat aloitatte aloitattivat aloitettava aloitettevaksi
aloitettu aloitimme aloitin aloitit aloititte aloittaa aloittamatta
aloitti aloittivat alta aluksi alussa alusta annettavaksi annetteva
annettu ansiosta antaa antamatta antoi aoua apu asia asiaa asian
asiasta asiat asioiden asioihin asioita asti avuksi avulla avun avutta
edelle edelleen edellä edeltä edemmäs edes edessä edestä ehkä ei eikä
eilen eivät eli ellei elleivät ellemme ellen ellet ellette emme en
enemmän eniten ennen ensi ensimmäinen ensimmäiseksi ensimmäisen
ensimmäisenä ensimmäiset ensimmäisiksi ensimmäisinä ensimmäisiä
ensimmäistä ensin entinen entisen entisiä entisten entistä enää eri
erittäin erityisesti eräiden eräs eräät esi esiin esillä esimerkiksi
et eteen etenkin etessa ette ettei että haikki halua haluaa haluamatta
haluamme haluan haluat haluatte haluavat halunnut halusi halusimme
halusin halusit halusitte halusivat halutessa haluton he hei heidän
heidät heihin heille heillä heiltä heissä heistä heitä helposti heti
hetkellä hieman hitaasti hoikein huolimatta huomenna hyvien hyviin
hyviksi hyville hyviltä hyvin hyvinä hyvissä hyvistä hyviä hyvä hyvät
hyvää hän häneen hänelle hänellä häneltä hänen hänessä hänestä hänet
häntä ihan ilman ilmeisesti itse itsensä itseään ja jo johon joiden
joihin joiksi joilla joille joilta joina joissa joista joita joka
jokainen jokin joko joksi joku jolla jolle jolloin jolta jompikumpi
jona jonka jonkin jonne joo jopa jos joskus jossa josta jota jotain
joten jotenkin jotenkuten jotka jotta jouduimme jouduin jouduit
jouduitte joudumme joudun joudutte joukkoon joukossa joukosta joutua
joutui joutuivat joutumaan joutuu joutuvat juuri jälkeen jälleen jää
kahdeksan kahdeksannen kahdella kahdelle kahdelta kahden kahdessa
kahdesta kahta kahteen kai kaiken kaikille kaikilta kaikkea kaikki
kaikkia kaikkiaan kaikkialla kaikkialle kaikkialta kaikkien kaikkin
kaksi kannalta kannattaa kanssa kanssaan kanssamme kanssani kanssanne
kanssasi kauan kauemmas kaukana kautta kehen keiden keihin keiksi
keille keillä keiltä keinä keissä keistä keitten keittä keitä keneen
keneksi kenelle kenellä keneltä kenen kenenä kenessä kenestä kenet
kenettä kennessästä kenties kerran kerta kertaa keskellä kesken
keskimäärin ketkä ketä kiitos kohti koko kokonaan kolmas kolme kolmen
kolmesti koska koskaan kovin kuin kuinka kuinkan kuitenkaan kuitenkin
kuka kukaan kukin kukka kumpainen kumpainenkaan kumpi kumpikaan
kumpikin kun kuten kuuden kuusi kuutta kylliksi kyllä kymmenen kyse
liian liki lisäksi lisää lla luo luona lähekkäin lähelle lähellä
läheltä lähemmäs lähes lähinnä lähtien läpi mahdollisimman mahdollista
me meidän meidät meihin meille meillä meiltä meissä meistä meitä
melkein melko menee meneet menemme menen menet menette menevät meni
menimme menin menit menivät mennessä mennyt menossa mihin mikin miksi
mikä mikäli mikään mille milloin milloinkan millä miltä minkä minne
minua minulla minulle minulta minun minussa minusta minut minuun minä
missä mistä miten mitkä mitä mitään moi molemmat mones monesti monet
moni moniaalla moniaalle moniaalta monta muassa muiden muita muka
mukaan mukaansa mukana mutta muu muualla muualle muualta muuanne
muulloin muun muut muuta muutama muutaman muuten myöhemmin myös
myöskin myöskään myötä ne neljä neljän neljää niiden niihin niiksi
niille niillä niiltä niin niinä niissä niistä niitä noiden noihin
noiksi noilla noille noilta noin noina noissa noista noita nopeammin
nopeasti nopeiten nro nuo nyt näiden näihin näiksi näille näillä
näiltä näin näinä näissä näissähin näissälle näissältä näissästä
näistä näitä nämä ohi oikea oikealla oikein ole olemme olen olet
olette oleva olevan olevat oli olimme olin olisi olisimme olisin
olisit olisitte olisivat olit olitte olivat olla olleet olli ollut oma
omaa omaan omaksi omalle omalta oman omassa omat omia omien omiin
omiksi omille omilta omissa omista on onkin onko ovat paikoittain
paitsi pakosti paljon paremmin parempi parhaillaan parhaiten
perusteella peräti pian pieneen pieneksi pienelle pienellä pieneltä
pienempi pienestä pieni pienin poikki puolesta puolestaan päälle
runsaasti saakka sadam sama samaa samaan samalla samallalta samallassa
samallasta saman samat samoin sata sataa satojen se seitsemän sekä sen
seuraavat siellä sieltä siihen siinä siis siitä sijaan siksi sille
silloin sillä silti siltä sinne sinua sinulla sinulle sinulta sinun
sinussa sinusta sinut sinuun sinä sisäkkäin sisällä siten sitten sitä
ssa sta suoraan suuntaan suuren suuret suuri suuria suurin suurten taa
taas taemmas tahansa tai takaa takaisin takana takia tallä tapauksessa
tarpeeksi tavalla tavoitteena te teidän teidät teihin teille teillä
teiltä teissä teistä teitä tietysti todella toinen toisaalla toisaalle
toisaalta toiseen toiseksi toisella toiselle toiselta toisemme toisen
toisensa toisessa toisesta toista toistaiseksi toki tosin tuhannen
tuhat tule tulee tulemme tulen tulet tulette tulevat tulimme tulin
tulisi tulisimme tulisin tulisit tulisitte tulisivat tulit tulitte
tulivat tulla tulleet tullut tuntuu tuo tuohon tuoksi tuolla tuolle
tuolloin tuolta tuon tuona tuonne tuossa tuosta tuota tuotä tuskin
tykö tähän täksi tälle tällä tällöin tältä tämä tämän tänne tänä
tänään tässä tästä täten tätä täysin täytyvät täytyy täällä täältä
ulkopuolella usea useasti useimmiten usein useita uudeksi uudelleen
uuden uudet uusi uusia uusien uusinta uuteen uutta vaan vahemmän vai
vaiheessa vaikea vaikean vaikeat vaikeilla vaikeille vaikeilta
vaikeissa vaikeista vaikka vain varmasti varsin varsinkin varten vasen
vasenmalla vasta vastaan vastakkain vastan verran vielä vierekkäin
vieressä vieri viiden viime viimeinen viimeisen viimeksi viisi voi
voidaan voimme voin voisi voit voitte voivat vuoden vuoksi vuosi
vuosien vuosina vuotta vähemmän vähintään vähiten vähän välillä
yhdeksän yhden yhdessä yhteen yhteensä yhteydessä yhteyteen yhtä
yhtäälle yhtäällä yhtäältä yhtään yhä yksi yksin yksittäin yleensä
ylemmäs yli ylös ympäri älköön älä
""".split())

TABLES["ga"] = frozenset("""
a ach ag agus an aon ar arna as b' ba beirt bhúr caoga ceathair
ceathrar chomh chtó chuig chun cois céad cúig cúigear d' daichead dar
de deich deichniúr den dhá do don dtí dá dár dó faoi faoin faoina
faoinár fara fiche gach gan go gur haon hocht i iad idir in ina ins
inár is le leis lena lenár m' mar mo mé na nach naoi naonúr ná ní níor
nó nócha ocht ochtar os roimh sa seacht seachtar seachtó seasca
seisear siad sibh sinn sna sé sí tar thar thú triúr trí trína trínár
tríocha tú um ár é éis í ó ón óna ónár
""".split())

TABLES["hi"] = frozenset("""
अंदर अत अदि अप अपना अपनि अपनी अपने अभि अभी आदि आप इंहिं इंहें इंहों
इतयादि इत्यादि इन इनका इन्हीं इन्हें इन्हों इस इसका इसकि इसकी इसके
इसमें इसि इसी इसे उंहिं उंहें उंहों उन उनका उनकि उनकी उनके उनको उन्हीं
उन्हें उन्हों उस उसके उसि उसी उसे एक एवं एस एसे ऐसे ओर और कइ कई कर
करता करते करना करने करें कहते कहा का काफि काफ़ी कि किंहें किंहों कितना
किन्हें किन्हों किया किर किस किसि किसी किसे की कुछ कुल के को कोइ कोई
कोन कोनसा कौन कौनसा गया घर जब जहाँ जहां जा जिंहें जिंहों जितना जिधर
जिन जिन्हें जिन्हों जिस जिसे जीधर जेसा जेसे जैसा जैसे जो तक तब तरह
तिंहें तिंहों तिन तिन्हें तिन्हों तिस तिसे तो था थि थी थे दबारा दवारा
दिया दुसरा दुसरे दूसरे दो द्वारा न नहिं नहीं ना निचे निहायत नीचे ने पर
पहले पुरा पूरा पे फिर बनि बनी बहि बही बहुत बाद बाला बिलकुल भि भितर भी
भीतर मगर मानो मे में यदि यह यहाँ यहां यहि यही या यिह ये रखें रवासा रहा
रहे ऱ्वासा लिए लिये लेकिन व वगेरह वरग वर्ग वह वहाँ वहां वहिं वहीं वाले
वुह वे वग़ैरह संग सकता सकते सबसे सभि सभी साथ साबुत साभ सारा से सो हि ही
हुअ हुआ हुइ हुई हुए हे हें है हैं हो होता होति होती होते होना होने
""".split())

TABLES["hu"] = frozenset("""
a abba abban abból addig ahhoz ahogy ahol aki akik akkor akár alapján
alatt alatta alattad alattam alattatok alattuk alattunk alá alád
alájuk alám alánk alátok alól alóla alólad alólam alólatok alóluk
alólunk amely amelybol amelyek amelyekben amelyeket amelyet amelyik
amelynek ami amikor amit amolyan amott amíg annak annál arra arról
attól az aznap azok azokat azokba azokban azokból azokhoz azokig
azokkal azokká azoknak azoknál azokon azokra azokról azoktól azokért
azon azonban azonnal azt aztán azután azzal azzá azért bal balra ban
be belé beléd beléjük belém belénk belétek belül belőle belőled
belőlem belőletek belőlük belőlünk ben benne benned bennem bennetek
bennük bennünk bár bárcsak bármilyen búcsú cikk cikkek cikkeket csak
csakhogy csupán de dehogy e ebbe ebben ebből eddig egy egyebek egyebet
egyedül egyelőre egyes egyet egyetlen egyik egymás egyre egyszerre
egyéb együtt egész egészen ehhez ekkor el eleinte ellen ellenes elleni
ellenére elmondta elsõ első elsők elsősorban elsőt elé eléd elég
eléjük elém elénk elétek elõ elõször elõtt elő előbb elől előle előled
előlem előletek előlük előlünk először előtt előtte előtted előttem
előttetek előttük előttünk előző emilyen engem ennek ennyi ennél enyém
erre erről esetben ettől ez ezek ezekbe ezekben ezekből ezeken ezeket
ezekhez ezekig ezekkel ezekké ezeknek ezeknél ezekre ezekről ezektől
ezekért ezen ezentúl ezer ezret ezt ezután ezzel ezzé ezért fel fele
felek felet felett felé fent fenti fél fölé gyakran ha halló hamar
hanem harmadik harmadikat harminc hat hatodik hatodikat hatot hatvan
helyett hetedik hetediket hetet hetven hirtelen hiszen hiába hogy
hogyan hol holnap holnapot honnan hova hozzá hozzád hozzájuk hozzám
hozzánk hozzátok hurrá huszadik hány hányszor hármat három hát hátha
hátulsó hét húsz ide ide-оda idén igazán igen ill ill. illetve ilyen
ilyenkor immár inkább is ismét ison itt jelenleg jobban jobbra jó jól
jólesik jóval jövőre kell kellene kellett kelljen keressünk keresztül
ketten kettő kettőt kevés ki kiben kiből kicsit kicsoda kihez kik
kikbe kikben kikből kiken kiket kikhez kikkel kikké kiknek kiknél
kikre kikről kiktől kikért kilenc kilencedik kilencediket kilencet
kilencven kin kinek kinél kire kiről kit kitől kivel kivé kié kiért
korábban képest kérem kérlek kész késő később későn két kétszer kívül
körül köszönhetően köszönöm közben közel közepesen közepén közé között
közül külön különben különböző különbözőbb különbözőek lassan le
legalább legyen lehet lehetetlen lehetett lehetőleg lehetőség lenne
lenni lennék lennének lesz leszek lesznek leszünk lett lettek lettem
lettünk lévő ma maga magad magam magatokat magukat magunkat magát mai
majd majdnem manapság meg megcsinál megcsinálnak megint megvan mellett
mellette melletted mellettem mellettetek mellettük mellettünk mellé
melléd melléjük mellém mellénk mellétek mellől mellőle mellőled
mellőlem mellőletek mellőlük mellőlünk mely melyek melyik mennyi mert
mi miatt miatta miattad miattam miattatok miattuk miattunk mibe miben
miből mihez mik mikbe mikben mikből miken miket mikhez mikkel mikké
miknek miknél mikor mikre mikről miktől mikért milyen min mind
mindegyik mindegyiket minden mindenesetre mindenki mindent mindenütt
mindig mindketten minek minket mint mintha minél mire miről mit mitől
mivel mivé miért mondta most mostanáig már más másik másikat másnap
második másodszor mások másokat mást még mégis míg mögé mögéd mögéjük
mögém mögénk mögétek mögött mögötte mögötted mögöttem mögöttetek
mögöttük mögöttünk mögül mögüle mögüled mögülem mögületek mögülük
mögülünk múltkor múlva na nagy nagyobb nagyon naponta napot ne
negyedik negyediket negyven neked nekem neki nekik nektek nekünk nem
nemcsak nemrég nincs nyolc nyolcadik nyolcadikat nyolcat nyolcvan nála
nálad nálam nálatok náluk nálunk négy négyet néha néhány nélkül o oda
ok olyan onnan ott pedig persze pár például rajta rajtad rajtam
rajtatok rajtuk rajtunk rendben rosszul rá rád rájuk rám ránk rátok
régen régóta részére róla rólad rólam rólatok róluk rólunk rögtön s
saját se sem semmi semmilyen semmiség senki soha sok sokan sokat
sokkal sokszor sokáig során stb. szemben szerbusz szerint szerinte
szerinted szerintem szerintetek szerintük szerintünk szervusz szinte
számára száz századik százat szépen szét szíves szívesen szíveskedjék
sőt talán tavaly te tegnap tegnapelőtt tehát tele teljes tessék ti
tied titeket tizedik tizediket tizenegy tizenegyedik tizenhat
tizenhárom tizenhét tizenkettedik tizenkettő tizenkilenc tizenkét
tizennyolc tizennégy tizenöt tizet tovább további továbbá távol téged
tényleg tíz több többi többször túl tőle tőled tőlem tőletek tőlük
tőlünk ugyanakkor ugyanez ugyanis ugye urak uram urat utoljára utolsó
után utána vagy vagyis vagyok vagytok vagyunk vajon valahol valaki
valakit valamelyik valami valamint való van vannak vele veled velem
veletek velük velünk vissza viszlát viszont viszontlátásra volna
volnának volnék volt voltak voltam voltunk végre végén végül által
általában ám át éljen én éppen érte érted értem értetek értük értünk
és év évben éve évek éves évi évvel így óta õ õk õket ön önbe önben
önből önhöz önnek önnel önnél önre önről önt öntől önért önök önökbe
önökben önökből önöket önökhöz önökkel önöknek önöknél önökre önökről
önöktől önökért önökön önön össze öt ötven ötödik ötödiket ötöt úgy
úgyis úgynevezett új újabb újra úr ő ők őket őt
""".split())

TABLES["hy"] = frozenset("""
այդ այլ այն այս դու դուք եմ են ենք ես եք է էի էին էինք էիր էիք էր ըստ
թ ի ին իսկ իր կամ համար հետ հետո մենք մեջ մի ն նա նաև նրա նրանք որ որը
որոնք որպես ու ում պիտի վրա և
""".split())

TABLES["id"] = frozenset("""
ada adalah adanya adapun agak agaknya agar akan akankah akhir akhiri
akhirnya aku akulah amat amatlah anda andalah antar antara antaranya
apa apaan apabila apakah apalagi apatah artinya asal asalkan atas atau
ataukah ataupun awal awalnya bagai bagaikan bagaimana bagaimanakah
bagaimanapun bagi bagian bahkan bahwa bahwasanya baik bakal bakalan
balik banyak bapak baru bawah beberapa begini beginian beginikah
beginilah begitu begitukah begitulah begitupun bekerja belakang
belakangan belum belumlah benar benarkah benarlah berada berakhir
berakhirlah berakhirnya berapa berapakah berapalah berapapun berarti
berawal berbagai berdatangan beri berikan berikut berikutnya berjumlah
berkali-kali berkata berkehendak berkeinginan berkenaan berlainan
berlalu berlangsung berlebihan bermacam bermacam-macam bermaksud
bermula bersama bersama-sama bersiap bersiap-siap bertanya
bertanya-tanya berturut berturut-turut bertutur berujar berupa besar
betul betulkah biasa biasanya bila bilakah bisa bisakah boleh bolehkah
bolehlah buat bukan bukankah bukanlah bukannya bulan bung cara caranya
cukup cukupkah cukuplah cuma dahulu dalam dan dapat dari daripada
datang dekat demi demikian demikianlah dengan depan di dia diakhiri
diakhirinya dialah diantara diantaranya diberi diberikan diberikannya
dibuat dibuatnya didapat didatangkan digunakan diibaratkan
diibaratkannya diingat diingatkan diinginkan dijawab dijelaskan
dijelaskannya dikarenakan dikatakan dikatakannya dikerjakan diketahui
diketahuinya dikira dilakukan dilalui dilihat dimaksud dimaksudkan
dimaksudkannya dimaksudnya diminta dimintai dimisalkan dimulai
dimulailah dimulainya dimungkinkan dini dipastikan diperbuat
diperbuatnya dipergunakan diperkirakan diperlihatkan diperlukan
diperlukannya dipersoalkan dipertanyakan dipunyai diri dirinya
disampaikan disebut disebutkan disebutkannya disini disinilah
ditambahkan ditandaskan ditanya ditanyai ditanyakan ditegaskan
ditujukan ditunjuk ditunjuki ditunjukkan ditunjukkannya ditunjuknya
dituturkan dituturkannya diucapkan diucapkannya diungkapkan dong dua
dulu empat enggak enggaknya entah entahlah guna gunakan hal hampir
hanya hanyalah hari harus haruslah harusnya hendak hendaklah hendaknya
hingga ia ialah ibarat ibaratkan ibaratnya ibu ikut ingat ingat-ingat
ingin inginkah inginkan ini inikah inilah itu itukah itulah jadi
jadilah jadinya jangan jangankan janganlah jauh jawab jawaban jawabnya
jelas jelaskan jelaslah jelasnya jika jikalau juga jumlah jumlahnya
justru kala kalau kalaulah kalaupun kalian kami kamilah kamu kamulah
kan kapan kapankah kapanpun karena karenanya kasus kata katakan
katakanlah katanya ke keadaan kebetulan kecil kedua keduanya keinginan
kelamaan kelihatan kelihatannya kelima keluar kembali kemudian
kemungkinan kemungkinannya kenapa kepada kepadanya kesampaian
keseluruhan keseluruhannya keterlaluan ketika khususnya kini kinilah
kira kira-kira kiranya kita kitalah kok kurang lagi lagian lah lain
lainnya lalu lama lamanya lanjut lanjutnya lebih lewat lima luar macam
maka makanya makin malah malahan mampu mampukah mana manakala manalagi
masa masalah masalahnya masih masihkah masing masing-masing mau maupun
melainkan melakukan melalui melihat melihatnya memang memastikan
memberi memberikan membuat memerlukan memihak meminta memintakan
memisalkan memperbuat mempergunakan memperkirakan memperlihatkan
mempersiapkan mempersoalkan mempertanyakan mempunyai memulai
memungkinkan menaiki menambahkan menandaskan menanti menanti-nanti
menantikan menanya menanyai menanyakan mendapat mendapatkan mendatang
mendatangi mendatangkan menegaskan mengakhiri mengapa mengatakan
mengatakannya mengenai mengerjakan mengetahui menggunakan menghendaki
mengibaratkan mengibaratkannya mengingat mengingatkan menginginkan
mengira mengucapkan mengucapkannya mengungkapkan menjadi menjawab
menjelaskan menuju menunjuk menunjuki menunjukkan menunjuknya menurut
menuturkan menyampaikan menyangkut menyatakan menyebutkan menyeluruh
menyiapkan merasa mereka merekalah merupakan meski meskipun meyakini
meyakinkan minta mirip misal misalkan misalnya mula mulai mulailah
mulanya mungkin mungkinkah nah naik namun nanti nantinya nyaris
nyatanya oleh olehnya pada padahal padanya pak paling panjang pantas
para pasti pastilah penting pentingnya per percuma perlu perlukah
perlunya pernah persoalan pertama pertama-tama pertanyaan pertanyakan
pihak pihaknya pukul pula pun punya rasa rasanya rata rupanya saat
saatnya saja sajalah saling sama sama-sama sambil sampai sampai-sampai
sampaikan sana sangat sangatlah satu saya sayalah se sebab sebabnya
sebagai sebagaimana sebagainya sebagian sebaik sebaik-baiknya
sebaiknya sebaliknya sebanyak sebegini sebegitu sebelum sebelumnya
sebenarnya seberapa sebesar sebetulnya sebisanya sebuah sebut sebutlah
sebutnya secara secukupnya sedang sedangkan sedemikian sedikit
sedikitnya seenaknya segala segalanya segera seharusnya sehingga
seingat sejak sejauh sejenak sejumlah sekadar sekadarnya sekali
sekali-kali sekalian sekaligus sekalipun sekarang sekecil seketika
sekiranya sekitar sekitarnya sekurang-kurangnya sekurangnya sela
selagi selain selaku selalu selama selama-lamanya selamanya
selanjutnya seluruh seluruhnya semacam semakin semampu semampunya
semasa semasih semata semata-mata semaunya sementara semisal
semisalnya sempat semua semuanya semula sendiri sendirian sendirinya
seolah seolah-olah seorang sepanjang sepantasnya sepantasnyalah
seperlunya seperti sepertinya sepihak sering seringnya serta serupa
sesaat sesama sesampai sesegera sesekali seseorang sesuatu sesuatunya
sesudah sesudahnya setelah setempat setengah seterusnya setiap setiba
setibanya setidak-tidaknya setidaknya setinggi seusai sewaktu siap
siapa siapakah siapapun sini sinilah soal soalnya suatu sudah sudahkah
sudahlah supaya tadi tadinya tahu tahun tak tambah tambahnya tampak
tampaknya tandas tandasnya tanpa tanya tanyakan tanyanya tapi tegas
tegasnya telah tempat tengah tentang tentu tentulah tentunya tepat
terakhir terasa terbanyak terdahulu terdapat terdiri terhadap
terhadapnya teringat teringat-ingat terjadi terjadilah terjadinya
terkira terlalu terlebih terlihat termasuk ternyata tersampaikan
tersebut tersebutlah tertentu tertuju terus terutama tetap tetapi tiap
tiba tiba-tiba tidak tidakkah tidaklah tiga tinggi toh tunjuk turut
tutur tuturnya ucap ucapnya ujar ujarnya umum umumnya ungkap ungkapnya
untuk usah usai waduh wah wahai waktu waktunya walau walaupun wong
yaitu yakin yakni yang
""".split())

TABLES["jp"] = frozenset("""
これ それ あれ この その あの ここ そこ あそこ こちら どこ だれ なに なん 何 私 貴方 貴方方 我々 私達 あの人 あのかた
彼女 彼 です あります おります います は が の に を で え から まで より も どの と し それで しかし
""".split())

TABLES["ko"] = frozenset("""
가 가까스로 가령 각 각각 각자 각종 갖고말하자면 같다 같이 개의치않고 거니와 거바 거의 것 것과 같이 것들 게다가 게우다
겨우 견지에서 결과에 이르다 결국 결론을 낼 수 있다 겸사겸사 고려하면 고로 곧 공동으로 과 과연 관계가 있다 관계없이
관련이 있다 관하여 관한 관해서는 구 구체적으로 구토하다 그 그들 그때 그래 그래도 그래서 그러나 그러니 그러니까 그러면
그러므로 그러한즉 그런 까닭에 그런데 그런즉 그럼 그럼에도 불구하고 그렇게 함으로써 그렇지 그렇지 않다면 그렇지 않으면
그렇지만 그렇지않으면 그리고 그리하여 그만이다 그에 따르는 그위에 그저 그중에서 그치지 않다 근거로 근거하여 기대여 기점으로
기준으로 기타 까닭으로 까악 까지 까지 미치다 까지도 꽈당 끙끙 끼익 나 나머지는 남들 남짓 너 너희 너희들 네 넷 년
논하지 않다 놀라다 누가 알겠는가 누구 다른 다른 방면으로 다만 다섯 다소 다수 다시 말하자면 다시말하면 다음 다음에 다음으로
단지 답다 당신 당장 대로 하다 대하면 대하여 대해 말하자면 대해서 댕그 더구나 더군다나 더라도 더불어 더욱더 더욱이는
도달하다 도착하다 동시에 동안 된바에야 된이상 두번째로 둘 둥둥 뒤따라 뒤이어 든간에 들 등 등등 딩동 따라 따라서 따위
따지지 않다 딱 때 때가 되어 때문에 또 또한 뚝뚝 라 해도 령 로 로 인하여 로부터 로써 륙 를 마음대로 마저 마저도 마치
막론하고 만 못하다 만약 만약에 만은 아니다 만이 아니다 만일 만큼 말하자면 말할것도 없고 매 매번 메쓰겁다 몇 모 모두 무렵
무릎쓰고 무슨 무엇 무엇때문에 물론 및 바꾸어말하면 바꾸어말하자면 바꾸어서 말하면 바꾸어서 한다면 바꿔 말하면 바로 바와같이
밖에 안된다 반대로 반대로 말하자면 반드시 버금 보는데서 보다더 보드득 본대로 봐 봐라 부류의 사람들 부터 불구하고 불문하고
붕붕 비걱거리다 비교적 비길수 없다 비로소 비록 비슷하다 비추어 보아 비하면 뿐만 아니라 뿐만아니라 뿐이다 삐걱 삐걱거리다 사
삼 상대적으로 말하자면 생각한대로 설령 설마 설사 셋 소생 소인 솨 쉿 습니까 습니다 시각 시간 시작하여 시초에 시키다 실로
심지어 아 아니 아니나다를가 아니라면 아니면 아니었다면 아래윗 아무거나 아무도 아야 아울러 아이 아이고 아이구 아이야 아이쿠
아하 아홉 안 그러면 않기 위하여 않기 위해서 알 수 있다 알았어 앗 앞에서 앞의것 야 약간 양자 어 어기여차 어느 어느 년도
어느것 어느곳 어느때 어느쪽 어느해 어디 어때 어떠한 어떤 어떤것 어떤것들 어떻게 어떻해 어이 어째서 어쨋든 어쩔수 없다 어찌
어찌됏든 어찌됏어 어찌하든지 어찌하여 언제 언젠가 얼마 얼마 안 되는 것 얼마간 얼마나 얼마든지 얼마만큼 얼마큼 엉엉 에
에 가서 에 달려 있다 에 대해 에 있다 에 한하다 에게 에서 여 여기 여덟 여러분 여보시오 여부 여섯 여전히 여차 연관되다
연이서 영 영차 옆사람 예 예를 들면 예를 들자면 예컨대 예하면 오 오로지 오르다 오자마자 오직 오호 오히려 와
와 같은 사람들 와르르 와아 왜 왜냐하면 외에도 요만큼 요만한 것 요만한걸 요컨대 우르르 우리 우리들 우선 우에 종합한것과같이
운운 월 위에서 서술한바와같이 위하여 위해서 윙윙 육 으로 으로 인하여 으로서 으로써 을 응 응당 의 의거하여 의지하여 의해
의해되다 의해서 이 이 되다 이 때문에 이 밖에 이 외에 이 정도의 이것 이곳 이때 이라면 이래 이러이러하다 이러한 이런
이럴정도로 이렇게 많은 것 이렇게되면 이렇게말하자면 이렇구나 이로 인하여 이르기까지 이리하여 이만큼 이번 이봐 이상 이어서
이었다 이와 같다 이와 같은 이와 반대로 이와같다면 이외에도 이용하여 이유만으로 이젠 이지만 이쪽 이천구 이천육 이천칠 이천팔
인 듯하다 인젠 일 일것이다 일곱 일단 일때 일반적으로 일지라도 임에 틀림없다 입각하여 입장에서 잇따라 있다 자 자기 자기집
자마자 자신 잠깐 잠시 저 저것 저것만큼 저기 저쪽 저희 전부 전자 전후 점에서 보아 정도에 이르다 제 제각기 제외하고 조금
조차 조차도 졸졸 좀 좋아 좍좍 주룩주룩 주저하지 않고 줄은 몰랏다 줄은모른다 중에서 중의하나 즈음하여 즉 즉시 지든지 지만
지말고 진짜로 쪽으로 차라리 참 참나 첫번째로 쳇 총적으로 총적으로 말하면 총적으로 보면 칠 콸콸 쾅쾅 쿵 타다 타인 탕탕
토하다 통하여 툭 퉤 틈타 팍 팔 퍽 펄렁 하 하게될것이다 하게하다 하겠는가 하고 있다 하고있었다 하곤하였다 하구나
하기 때문에 하기 위하여 하기는한데 하기만 하면 하기보다는 하기에 하나 하느니 하는 김에 하는 편이 낫다 하는것도
하는것만 못하다 하는것이 낫다 하는바 하더라도 하도다 하도록시키다 하도록하다 하든지 하려고하다 하마터면 하면 할수록 하면된다
하면서 하물며 하여금 하여야 하자마자 하지 않는다면 하지 않도록 하지마 하지마라 하지만 하하 한 까닭에 한 이유는 한 후
한다면 한다면 몰라도 한데 한마디 한적이있다 한켠으로는 한항목 할 따름이다 할 생각이다 할 줄 안다 할 지경이다 할 힘이 있다
할때 할만하다 할망정 할뿐 할수있다 할수있어 할줄알다 할지라도 할지언정 함께 해도된다 해도좋다 해봐요 해서는 안된다 해야한다
해요 했어요 향하다 향하여 향해서 허 허걱 허허 헉 헉헉 헐떡헐떡 형식으로 쓰여 혹시 혹은 혼자 훨씬 휘익 휴 흐흐 흥 힘입어
""".split())

TABLES["lt"] = frozenset("""
abi abidvi abiejose abiejuose abiejø abiem abigaliai abipus abu abudu
ai ana anaiptol anaisiais anajai anajam anajame anapus anas anasai
anasis anei aniedvi anieji aniesiems anoji anojo anojoje anokia anoks
anosiomis anosioms anosios anosiose anot ant antai anuodu anuoju
anuosiuose anuosius anàja anàjà anàjá anàsias anøjø apie aplink ar
arba argi arti aukðèiau að be bei beje bemaþ bent bet betgi beveik dar
dargi daugmaþ deja dëka dël dëlei dëlto ech et gal galbût galgi gan
gana gi greta idant iki ir irgi it itin ið iðilgai iðvis jaisiais
jajai jajam jajame jei jeigu ji jiedu jiedvi jieji jiesiems jinai jis
jisai jog joji jojo jojoje jokia joks josiomis josioms josios josiose
judu judvi juk jumis jums jumyse juodu juoju juosiuose juosius jus
jàja jàjà jàsias jájá jøjø jûs jûsiðkis jûsiðkë jûsø kad kada kadangi
kai kaip kaipgi kas katra katras katriedvi katruodu kaþin kaþkas
kaþkatra kaþkatras kaþkokia kaþkoks kaþkuri kaþkuris kiaurai kiek
kiekvienas kieno kita kitas kitokia kitoks kodël kokia koks kol kolei
kone kuomet kur kurgi kuri kuriedvi kuris kuriuodu lai lig ligi link
lyg man manaisiais manajai manajam manajame manas manasai manasis mane
manieji maniesiems manim manimi maniðkis maniðkë mano manoji manojo
manojoje manosiomis manosioms manosios manosiose manuoju manuosiuose
manuosius manyje manàja manàjà manàjá manàsias manæs manøjø mat
maþdaug maþne mes mudu mudvi mumis mums mumyse mus mûsiðkis mûsiðkë
mûsø na nagi ne nebe nebent negi negu nei nejau nejaugi nekaip
nelyginant nes net netgi netoli neva nors nuo në o ogi oi paeiliui
pagal pakeliui palaipsniui palei pas pasak paskos paskui paskum pat
pati patiems paties pats patys patá paèiais paèiam paèiame paèiu
paèiuose paèius paèiø per pernelyg pirm pirma pirmiau po prie prieð
prieðais pro pusiau rasi rodos sau savaisiais savajai savajam savajame
savas savasai savasis save savieji saviesiems savimi saviðkis saviðkë
savo savoji savojo savojoje savosiomis savosioms savosios savosiose
savuoju savuosiuose savuosius savyje savàja savàjà savàjá savàsias
savæs savøjø skersai skradþiai staèiai su sulig ta tad tai taigi taip
taipogi taisiais tajai tajam tajame tamsta tarp tarsi tartum tarytum
tas tasai tau tavaisiais tavajai tavajam tavajame tavas tavasai
tavasis tave tavieji taviesiems tavimi taviðkis taviðkë tavo tavoji
tavojo tavojoje tavosiomis tavosioms tavosios tavosiose tavuoju
tavuosiuose tavuosius tavyje tavàja tavàjà tavàjá tavàsias tavæs
tavøjø taèiau te tegu tegul tiedvi tieji ties tiesiems tiesiog tik
tikriausiai tiktai toji tojo tojoje tokia toks tol tolei toliau
tosiomis tosioms tosios tosiose tu tuodu tuoju tuosiuose tuosius
turbût tàja tàjà tàjá tàsias tøjø tûlas uþ uþtat uþvis va vai viduj
vidury vien vienas vienokia vienoks vietoj virð virðuj virðum vis
vis dëlto visa visas visgi visokia visoks vos vël vëlgi ypaè á ákypai
ástriþai ðalia ðe ði ðiaisiais ðiajai ðiajam ðiajame ðiapus ðiedvi
ðieji ðiesiems ðioji ðiojo ðiojoje ðiokia ðioks ðiosiomis ðiosioms
ðiosios ðiosiose ðis ðisai ðit ðita ðitas ðitiedvi ðitokia ðitoks
ðituodu ðiuodu ðiuoju ðiuosiuose ðiuosius ðiàja ðiàjà ðiàsias ðiøjø
ðtai ðájá þemiau
""".split())

TABLES["ne"] = frozenset("""
अक्सर अगाडि अझै अनुसार अन्तर्गत अन्य अन्यत्र अन्यथा अब अरू अरूलाई
अर्को अर्थात अर्थात् अलग आए आजको आठ आत्म आदि आफू आफूलाई आफैलाई आफ्नै
आफ्नो आयो उदाहरण उन उनको उनले उप उहाँलाई एउटै एक एकदम औं कतै कम से कम
कसरी कसै कसैले कहाँबाट कहिलेकाहीं कहिल्यै कहीं का कि किन किनभने कुनै
कुरा कृपया के केहि केही को कोही क्रमशः गए गरि गरी गरेका गरेको गरेर
गरौं गर्छ गर्छु गर्दै गर्न गर्नु गर्नुपर्छ गर्ने गर्यौं गैर चाँडै चार
चाले चाहनुहुन्छ चाहन्छु चाहिए छ छन् छु छैन छौँ छौं जताततै जब जबकि जसको
जसबाट जसमा जसलाई जसले जस्तै जस्तो जस्तोसुकै जहाँ जान जाहिर जुन जे जो
ठीक त तत्काल तथा तदनुसार तपाइँको तपाईं तर तल तापनि तिनी तिनीहरू
तिनीहरूको तिनीहरूलाई तिनीहरूले तिमी तिर ती तीन तुरुन्तै तेस्रो
त्यसकारण त्यसपछि त्यसमा त्यसैले त्यहाँ त्यो थिए थिएन थिएनन् थियो दिए
दिनुभएको दिनुहुन्छ दुई देख देखि देखिन्छ देखियो देखे देखेको देखेर देख्न
दोश्रो दोस्रो धेरै न नजिकै नत्र नयाँ नि निम्ति निम्न निम्नानुसार
निर्दिष्ट नै नौ पक्का पक्कै पछि पछिल्लो पटक पनि पर्छ पर्थ्यो पर्याप्त
पहिले पहिलो पहिल्यै पाँच पाँचौं पूर्व प्रति प्रत्येक प्लस फेरि बने
बन्द बन्न बरु बाटो बारे बाहिर बाहेक बीच बीचमा भए भएको भन भने भने्
भन्छन् भन्छु भन्दा भन्नुभयो भन्ने भर भित्र भित्री म मलाई मा मात्र माथि
मुख्य मेरो यति यथोचित यदि यद्यपि यस यसको यसपछि यसबाहेक यसरी यसो यस्तो
यहाँ यहाँसम्म या यी यो र रही रहेका रहेको राखे राख्छ राम्रो रूप लगभग
लाई लागि ले वरिपरि वास्तवमा वाहेक विरुद्ध विशेष शायद सँग सँगै सक्छ
सट्टा सधैं सबै सबैलाई समय सम्भव सम्म सही साँच्चै सात साथ साथै सायद
सारा सो सोध्न सोही स्पष्ट हरे हरेक हामी हामीलाई हाम्रो हुँ हुन हुने
हुनेछ हुन् हुन्छ हो होइन होइनन् होला होस्
""".split())

TABLES["no"] = frozenset("""
alle andre arbeid at av bare begge ble blei bli blir blitt bort bra
bruke både båe da de deg dei deim deira deires dem den denne der dere
deres det dette di din disse ditt du dykk dykkar då eg ein eit eitt
eller elles en ene eneste enhver enn er et ett etter folk for fordi
forsûke fra få før fûr fûrst gjorde gjûre god gå ha hadde han hans har
hennar henne hennes her hjå ho hoe honom hoss hossen hun hva hvem hver
hvilke hvilken hvis hvor hvordan hvorfor i ikke ikkje ingen ingi inkje
inn innen inni ja jeg kan kom korleis korso kun kunne kva kvar
kvarhelst kven kvi kvifor lage lang lik like makt man mange me med
medan meg meget mellom men mens mer mest mi min mine mitt mot mye
mykje må måte navn ned nei no noe noen noka noko nokon nokor nokre ny
nå når og også om opp oss over part punkt på rett riktig samme sant
seg selv si sia sidan siden sin sine sist sitt sjøl skal skulle slik
slutt so som somme somt start stille så sånn tid til tilbake tilstand
um under upp ut uten var vart varte ved verdi vere verte vi vil ville
vite vore vors vort vår være vært vöre vört å
""".split())

TABLES["ro"] = frozenset("""
a abia acea aceasta această aceea aceeasi acei aceia acel acela
acelasi acele acelea acest acesta aceste acestea acestei acestia
acestui aceşti aceştia acolo acord acum adica ai aia aibă aici aiurea
al ala alaturi ale alea alt alta altceva altcineva alte altfel alti
altii altul am anume apoi ar are as asa asemenea asta astazi astea
astfel astăzi asupra atare atat atata atatea atatia ati atit atita
atitea atitia atunci au avea avem aveţi avut azi aş aşadar aţi b ba
bine bucur bună c ca cam cand capat care careia carora caruia cat
catre caut ce cea ceea cei ceilalti cel cele celor ceva chiar ci cinci
cind cine cineva cit cita cite citeva citi citiva conform contra cu
cui cum cumva curând curînd când cât câte câtva câţi cînd cît cîte
cîtva cîţi că căci cărei căror cărui către d da daca dacă dar dat
datorită dată dau de deasupra deci decit degraba deja deoarece departe
desi despre deşi din dinaintea dintr dintr- dintre doar doi doilea
două drept dupa după dă e ea ei el ele era eram este eu exact eşti f
face fara fata fel fi fie fiecare fii fim fiu fiţi foarte fost frumos
fără g geaba graţie h halbă i ia iar ieri ii il imi in inainte inapoi
inca incit insa intr intre isi iti j k l la le li lor lui lângă lîngă
m ma mai mare mea mei mele mereu meu mi mie mine mod mult multa multe
multi multă mulţi mulţumesc mâine mîine mă n ne nevoie ni nici
niciodata nicăieri nimeni nimeri nimic niste nişte noastre noastră noi
noroc nostri nostru nou noua nouă noştri nu numai o opt or ori oricare
orice oricine oricum oricând oricât oricînd oricît oriunde p pai parca
patra patru patrulea pe pentru peste pic pina plus poate pot prea
prima primul prin printr- putini puţin puţina puţină până pînă r rog s
sa sa-mi sa-ti sai sale sau se si sint sintem spate spre sub sunt
suntem sunteţi sus sută sînt sîntem sînteţi să săi său t ta tale te ti
timp tine toata toate toată tocmai tot toti totul totusi totuşi toţi
trei treia treilea tu tuturor tăi tău u ul ului un una unde undeva
unei uneia unele uneori unii unor unora unu unui unuia unul v va vi
voastre voastră voi vom vor vostru vouă voştri vreme vreo vreun vă x z
zece zero zi zice îi îl îmi împotriva în înainte înaintea încotro
încât încît între întrucât întrucît îţi ăla ălea ăsta ăstea ăştia
şapte şase şi ştiu ţi ţie
""".split())

TABLES["sa"] = frozenset("""
""".split())

TABLES["sl"] = frozenset("""
a ali april avgust b bi bil bila bile bili bilo biti blizu bo bodo
bojo bolj bom bomo boste bova boš brez c cel cela celi celo d da daleč
dan danes datum december deset deseta deseti deseto devet deveta
deveti deveto do dober dobra dobri dobro dokler dol dolg dolga dolgi
dovolj drug druga drugi drugo dva dve e eden en ena ene eni enkrat eno
etc. f februar g g. ga ga. gor gospa gospod h halo i idr. ii iii in iv
ix iz j januar jaz je ji jih jim jo julij junij jutri k kadarkoli kaj
kajti kako kakor kamor kamorkoli kar karkoli katerikoli kdaj kdo
kdorkoli ker ki kje kjer kjerkoli ko koder koderkoli koga komu kot
kratek kratka kratke kratki l lahka lahke lahki lahko le lep lepa lepe
lepi lepo leto m maj majhen majhna majhni malce malo manj marec me med
medtem mene mesec mi midva midve mnogo moj moja moje mora morajo moram
moramo morate moraš morem mu n na nad naj najina najino najmanj naju
največ nam narobe nas nato nazaj naš naša naše ne nedavno nedelja nek
neka nekaj nekatere nekateri nekatero nekdo neke nekega neki nekje
neko nekoga nekoč ni nikamor nikdar nikjer nikoli nič nje njega njegov
njegova njegovo njej njemu njen njena njeno nji njih njihov njihova
njihovo njiju njim njo njun njuna njuno no nocoj november npr. o ob
oba obe oboje od odprt odprta odprti okoli oktober on onadva one oni
onidve osem osma osmi osmo oz. p pa pet peta petek peti peto po pod
pogosto poleg poln polna polni polno ponavadi ponedeljek ponovno potem
povsod pozdravljen pozdravljeni prav prava prave pravi pravo prazen
prazna prazno prbl. precej pred prej preko pri pribl. približno primer
pripravljen pripravljena pripravljeni proti prva prvi prvo r ravno
redko res reč s saj sam sama same sami samo se sebe sebi sedaj sedem
sedma sedmi sedmo sem september seveda si sicer skoraj skozi slab smo
so sobota spet sreda srednja srednji sta ste stran stvar sva t ta tak
taka take taki tako takoj tam te tebe tebi tega težak težka težki
težko ti tista tiste tisti tisto tj. tja to toda torek tretja tretje
tretji tri tu tudi tukaj tvoj tvoja tvoje u v vaju vam vas vaš vaša
vaše ve vedno velik velika veliki veliko vendar ves več vi vidva vii
viii visok visoka visoke visoki vsa vsaj vsak vsaka vsakdo vsake vsaki
vsakomur vse vsega vsi vso včasih včeraj x z za zadaj zadnji zakaj
zaprta zaprti zaprto zdaj zelo zunaj č če često četrta četrtek četrti
četrto čez čigav š šest šesta šesti šesto štiri ž že
""".split())

TABLES["sr"] = frozenset("""
baš bez biæe bio biti blizu broj dana danas doæi dobar dobiti dok
dole došao drugi duž dva èesto èiji gde gore hvala iæi iako ide ima
imam imao ispod izmeðu iznad izvan izvoli jedan jedini jednom jeste
još juèe kad kako kao koga koja koje koji kroz mali manji misli mnogo
moæi mogu mora morao naæi naš negde nego nekad neki nemam nešto nije
nijedan nikada nismo ništa njega njegov njen njih njihov oko okolo ona
onaj oni ono osim ostali otišao ovako ovamo ovde ove ovo pitati
poèetak pojedini posle povodom praviti pre preko prema prvi put radije
sada smeti šta stvar stvarno sutra svaki sve svim svugde taèno tada
taj takoðe tamo tim uèinio uèiniti umalo unutra upotrebiti uzeti vaš
veæina veoma video više zahvaliti zašto zbog želeo želi znati
""".split())

TABLES["ta"] = frozenset("""
அங்கு அங்கே அடுத்த அதற்கு அதனால் அதன் அதிக அதில் அது அதே அதை அந்த
அந்தக் அந்தப் அல்லது அவரது அவர் அவர்கள் அவள் அவன் அவை அன்று ஆகிய
ஆகியோர் ஆகும் ஆனால் இங்கு இங்கே இடத்தில் இடம் இதற்கு இதனால் இதனை இதன்
இதில் இது இதை இந்த இந்தக் இந்தத் இந்தப் இப்போது இரு இருக்கும் இருந்த
இருந்தது இருந்து இல்லை இவர் இவை இன்னும் உள்ள உள்ளது உள்ளன உன் எந்த
எல்லாம் என எனக் எனக்கு எனப்படும் எனவும் எனவே எனினும் எனும் என் என்பது
என்பதை என்ற என்று என்றும் என்ன என்னும் ஏன் ஒரு ஒரே ஓர் கொண்ட கொண்டு
கொள்ள சற்று சில சிறு சேர்ந்த தவிர தனது தன் தான் நாம் நான் நீ பல பலரும்
பல்வேறு பற்றி பற்றிய பிற பிறகு பின் பின்னர் பெரும் பேர் போது போல போல்
போன்ற மட்டுமே மட்டும் மற்ற மற்றும் மிக மிகவும் மீது முதல் முறை மேலும்
மேல் யார் வந்த வந்து வரும் வரை வரையில் விட விட்டு வேண்டும் வேறு
""".split())

TABLES["tr"] = frozenset("""
acaba acep adamakıllı adeta ait altmýþ altmış altý altı ama amma anca
ancak arada artýk aslında aynen ayrıca az açıkça açıkçası bana bari
bazen bazý bazı başkası baţka belki ben benden beni benim beri beriki
beþ beş beţ bilcümle bile bin binaen binaenaleyh bir biraz birazdan
birbiri birden birdenbire biri birice birileri birisi birkaç birkaçı
birkez birlikte birçok birçoğu birþey birþeyi birşey birşeyi birţey
bitevi biteviye bittabi biz bizatihi bizce bizcileyin bizden bize bizi
bizim bizimki bizzat boşuna bu buna bunda bundan bunlar bunları
bunların bunu bunun buracıkta burada buradan burası böyle böylece
böylecene böylelikle böylemesine böylesine büsbütün bütün cuk cümlesi
da daha dahi dahil dahilen daima dair dayanarak de defa dek demin
demincek deminden denli derakap derhal derken deđil değil değin diye
diđer diğer diğeri doksan dokuz dolayı dolayısıyla doğru dört edecek
eden ederek edilecek ediliyor edilmesi ediyor elbet elbette elli emme
en enikonu epey epeyce epeyi esasen esnasında etmesi etraflı etraflıca
etti ettiği ettiğini evleviyetle evvel evvela evvelce evvelden
evvelemirde evveli eđer eğer fakat filanca gah gayet gayetle gayri
gayrı gelgelelim gene gerek gerçi geçende geçenlerde gibi gibilerden
gibisinden gine göre gırla hakeza halbuki halen halihazırda haliyle
handiyse hangi hangisi hani hariç hasebiyle hasılı hatta hele hem
henüz hep hepsi her herhangi herkes herkesin hiç hiçbir hiçbiri hoş
hulasaten iken iki ila ile ilen ilgili ilk illa illaki imdi indinde
inen insermi ise ister itibaren itibariyle itibarıyla iyi iyice
iyicene için iş işte iţte kadar kaffesi kah kala kanýmca karşın
katrilyon kaynak kaçı kelli kendi kendilerine kendini kendisi
kendisine kendisini kere kez keza kezalik keşke keţke ki kim kimden
kime kimi kimisi kimse kimsecik kimsecikler külliyen kýrk kýsaca kırk
kısaca lakin leh lütfen maada madem mademki mamafih mebni međer meğer
meğerki meğerse milyar milyon mu mü mý mı nasýl nasıl nasılsa nazaran
naşi ne neden nedeniyle nedenle nedense nerde nerden nerdeyse nere
nerede nereden neredeyse neresi nereye netekim neye neyi neyse nice
nihayet nihayetinde nitekim niye niçin o olan olarak oldu olduklarını
oldukça olduğu olduğunu olmadı olmadığı olmak olması olmayan olmaz
olsa olsun olup olur olursa oluyor on ona onca onculayın onda ondan
onlar onlardan onlari onlarýn onları onların onu onun oracık oracıkta
orada oradan oranca oranla oraya otuz oysa oysaki pek pekala peki
pekçe peyderpey rağmen sadece sahi sahiden sana sanki sekiz seksen sen
senden seni senin siz sizden sizi sizin sonra sonradan sonraları
sonunda tabii tam tamam tamamen tamamıyla tarafından tek trilyon tüm
var vardı vasıtasıyla ve velev velhasıl velhasılıkelam veya veyahut ya
yahut yakinen yakında yakından yakınlarda yalnız yalnızca yani yapacak
yapmak yaptı yaptıkları yaptığı yaptığını yapılan yapılması yapıyor
yedi yeniden yenilerde yerine yetmiþ yetmiş yetmiţ yine yirmi yok
yoksa yoluyla yüz yüzünden zarfında zaten zati zira çabuk çabukça
çeşitli çok çokları çoklarınca çokluk çoklukla çokça çoğu çoğun
çoğunca çoğunlukla çünkü öbür öbürkü öbürü önce önceden önceleri
öncelikle öteki ötekisi öyle öylece öylelikle öylemesine öz üzere üç
þey þeyden þeyi þeyler þu þuna þunda þundan þunu şayet şey şeyden şeyi
şeyler şu şuna şuncacık şunda şundan şunlar şunları şunu şunun şura
şuracık şuracıkta şurası şöyle ţayet ţimdi ţu ţöyle
""".split())

TABLES["uk"] = frozenset("""
авжеж адже але б без був була були було бути більш вам вас весь
вздовж ви вниз внизу вона вони воно все всередині всіх від він да
давай давати де дещо для до з завжди замість й коли ледве майже ми
навколо навіть нам от отже отож поза про під та так такий також те ти
тобто тож тощо хоча це цей чи чого що як який якої є із інших їх її
""".split())

TABLES["zh"] = frozenset("""
、 。 〈 〉 《 》 一 一个 一些 一何 一切 一则 一方面 一旦 一来 一样 一种 一般 一转眼 七 万一 三 上 上下 下 不
不仅 不但 不光 不单 不只 不外乎 不如 不妨 不尽 不尽然 不得 不怕 不惟 不成 不拘 不料 不是 不比 不然 不特 不独 不管
不至于 不若 不论 不过 不问 与 与其 与其说 与否 与此同时 且 且不说 且说 两者 个 个别 中 临 为 为了 为什么 为何 为止
为此 为着 乃 乃至 乃至于 么 之 之一 之所以 之类 乌乎 乎 乘 九 也 也好 也罢 了 二 二来 于 于是 于是乎 云云 云尔 五
些 亦 人 人们 人家 什 什么 什么样 今 介于 仍 仍旧 从 从此 从而 他 他人 他们 他们们 以 以上 以为 以便 以免 以及 以故
以期 以来 以至 以至于 以致 们 任 任何 任凭 会 似的 但 但凡 但是 何 何以 何况 何处 何时 余外 作为 你 你们 使 使得
例如 依 依据 依照 便于 俺 俺们 倘 倘使 倘或 倘然 倘若 借 借傥然 假使 假如 假若 做 像 儿 先不先 光 光是 全体 全部 八
六 兮 共 关于 关于具体地说 其 其一 其中 其二 其他 其余 其它 其次 具体地说 具体说来 兼之 内 再 再其次 再则 再有 再者
再者说 再说 冒 冲 况且 几 几时 凡 凡是 凭 凭借 出于 出来 分 分别 则 则甚 别 别人 别处 别是 别的 别管 别说 到 前后
前此 前者 加之 加以 区 即 即令 即使 即便 即如 即或 即若 却 去 又 又及 及 及其 及至 反之 反而 反过来 反过来说 受到 另
另一方面 另外 另悉 只 只当 只怕 只是 只有 只消 只要 只限 叫 叮咚 可 可以 可是 可见 各 各个 各位 各种 各自 同 同时 后
后者 向 向使 向着 吓 吗 否则 吧 吧哒 含 吱 呀 呃 呕 呗 呜 呜呼 呢 呵 呵呵 呸 呼哧 咋 和 咚 咦 咧 咱 咱们 咳 哇
哈 哈哈 哉 哎 哎呀 哎哟 哗 哟 哦 哩 哪 哪个 哪些 哪儿 哪天 哪年 哪怕 哪样 哪边 哪里 哼 哼唷 唉 唯有 啊 啐 啥 啦
啪达 啷当 喂 喏 喔唷 喽 嗡 嗡嗡 嗬 嗯 嗳 嘎 嘎登 嘘 嘛 嘻 嘿 嘿嘿 四 因 因为 因了 因此 因着 因而 固然 在 在下
在于 地 基于 处在 多 多么 多少 大 大家 她 她们 好 如 如上 如上所述 如下 如何 如其 如同 如是 如果 如此 如若 始而 孰料
孰知 宁 宁可 宁愿 宁肯 它 它们 对 对于 对待 对方 对比 将 小 尔 尔后 尔尔 尚且 就 就是 就是了 就是说 就算 就要 尽
尽管 尽管如此 岂但 己 已 已矣 巴 巴巴 年 并 并且 庶乎 庶几 开外 开始 归 归齐 当 当地 当然 当着 彼 彼时 彼此 往 待
很 得 得了 怎 怎么 怎么办 怎么样 怎奈 怎样 总之 总的来看 总的来说 总的说来 总而言之 恰恰相反 您 惟其 慢说 我 我们 或
或则 或是 或曰 或者 截至 所 所以 所在 所幸 所有 才 才能 打 打从 把 抑或 拿 按 按照 换句话说 换言之 据 据此 接着 故
故此 故而 旁人 无 无宁 无论 既 既往 既是 既然 日 时 时候 是 是以 是的 更 曾 替 替代 最 月 有 有些 有关 有及 有时
有的 望 朝 朝着 本 本人 本地 本着 本身 来 来着 来自 来说 极了 果然 果真 某 某个 某些 某某 根据 欤 正值 正如 正巧
正是 此 此地 此处 此外 此时 此次 此间 毋宁 每 每当 比 比及 比如 比方 没奈何 沿 沿着 漫说 点 焉 然则 然后 然而 照
照着 犹且 犹自 甚且 甚么 甚或 甚而 甚至 甚至于 用 用来 由 由于 由是 由此 由此可见 的 的确 的话 直到 相对而言 省得 看
眨眼 着 着呢 矣 矣乎 矣哉 离 秒 称 竟而 第 等 等到 等等 简言之 管 类如 紧接着 纵 纵令 纵使 纵然 经 经过 结果 给
继之 继后 继而 综上所述 罢了 者 而 而且 而况 而后 而外 而已 而是 而言 能 能否 腾 自 自个儿 自从 自各儿 自后 自家 自己
自打 自身 至 至于 至今 至若 致 般的 若 若夫 若是 若果 若非 莫不然 莫如 莫若 虽 虽则 虽然 虽说 被 要 要不 要不是
要不然 要么 要是 譬喻 譬如 让 许多 论 设使 设或 设若 诚如 诚然 该 说 说来 请 诸 诸位 诸如 谁 谁人 谁料 谁知 贼死
赖以 赶 起 起见 趁 趁着 越是 距 跟 较 较之 边 过 还 还是 还有 还要 这 这一来 这个 这么 这么些 这么样 这么点儿 这些
这会儿 这儿 这就是说 这时 这样 这次 这般 这边 这里 进而 连 连同 逐步 通过 遵循 遵照 那 那个 那么 那么些 那么样 那些
那会儿 那儿 那时 那样 那般 那边 那里 都 鄙人 鉴于 针对 阿 除 除了 除外 除开 除此之外 除非 随 随后 随时 随着 难道说 零
非 非但 非徒 非特 非独 靠 顺 顺着 首先
""".split())
